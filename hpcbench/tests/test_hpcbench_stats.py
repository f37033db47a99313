"""The yardstick's arithmetic: byte and flop counts, the percentile over
all requests, the rate over the window, and the busy and idle shares
read from a synthetic trace."""

import pytest

from hpcbench import roofline, stats
from hpcbench.drive import Reservoir
from hpcbench.trace import WINDOW, Trace


def test_spmv_work_counts_values_and_both_vectors_once():
    # flan: 112,665,600 values + x and y of 1,564,800 float32 each
    assert roofline.spmv_bytes(112_665_600, 1_564_800, 1_564_800) == \
        112_665_600 * 4 + 2 * 1_564_800 * 4
    assert roofline.spmv_flops(449_455_096) == 898_910_192
    least = roofline.spmv_least_seconds(449_455_096, 16_777_216, 16_777_216,
                                        "NVIDIA H100 80GB HBM3")
    # bound by bytes: (449,455,096 + 2 * 16,777,216) * 4 B over 3.35 TB/s
    assert least == pytest.approx(1_932_039_112 / 3.35e12)
    assert roofline.spmv_least_seconds(1, 1, 1, "some other card") is None


def test_percentile_is_over_every_request():
    lat = list(range(1, 101))             # 1..100 ms
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_over_the_whole_window():
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_and_gaps_of_intervals():
    busy = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.union_length(busy) == 3 + 1 + 4
    assert stats.union_length(busy, 2, 10) == 1 + 1 + 2
    assert stats.gaps(busy, 0, 10) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def synthetic_trace():
    """A window of 100 us: two matvec spans inside a request, a vector
    kernel outside them, one kernel with no launch record (a library
    launch), and host events over the gaps."""
    return [
        _x("user_annotation", WINDOW, 0, 100),
        _x("user_annotation", "hpcbench.request", 5, 90),
        _x("user_annotation", "hpcbench.matvec", 10, 10),
        _x("user_annotation", "hpcbench.matvec", 40, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
        _x("cpu_op", "aten::is_nonzero", 70, 20),
        _x("kernel", "spmv", 12, 8, tid=7, correlation=1, stream=7),
        _x("kernel", "glue", 20, 2, tid=7, correlation=99, stream=7),
        _x("kernel", "spmv", 42, 8, tid=7, correlation=2, stream=7),
        _x("kernel", "axpy", 61, 4, tid=7, correlation=3, stream=7),
        _x("kernel", "outside", 150, 5, tid=7, correlation=4, stream=7),
    ]


def test_trace_shares_from_synthetic_events():
    t = Trace(synthetic_trace())
    assert t.window_s == pytest.approx(100e-6)
    assert t.unlaunched == 2          # 'glue' and 'outside' have no launch
    assert t.span_count("hpcbench.matvec") == 2
    mv = t.ops_launched_in("hpcbench.matvec")
    # 'glue' follows a matvec kernel on its stream, so it is the matvec's
    assert sorted(op[2] for op in mv) == ["glue", "spmv", "spmv"]
    assert t.busy_s(mv) == pytest.approx(18e-6)
    vec = t.ops_launched_in("hpcbench.request", outside="hpcbench.matvec")
    # 'outside' takes axpy's launch, so it counts too, clipped to nothing
    assert [op[2] for op in vec] == ["axpy", "outside"]
    assert t.busy_s(vec) == pytest.approx(4e-6)
    assert t.busy_s() == pytest.approx(22e-6)        # 'outside' is clipped
    idle = 1 - t.busy_s() / t.window_s
    assert idle == pytest.approx(0.78)
    top = dict(t.top_device_ops())
    assert top["spmv"] == pytest.approx(16e-6)
    gaps = dict(t.idle_gaps())
    # the gap 65..100 has its middle inside aten::is_nonzero
    assert gaps["aten::is_nonzero"] == pytest.approx(35e-6)
    assert sum(gaps.values()) == pytest.approx(78e-6)


def test_trace_needs_its_window():
    with pytest.raises(ValueError):
        Trace([_x("kernel", "k", 0, 1)])


def test_reservoir_is_uniform_and_seeded():
    def picks(seed):
        r = Reservoir(4, seed)
        kept = [None] * 4
        for i in range(1000):
            s = r.slot()
            if s is not None:
                kept[s] = i
        return kept

    assert picks(5) == picks(5)
    assert picks(5) != picks(6)
    counts = [0] * 10
    for seed in range(400):
        for i in picks(seed):
            counts[i // 100] += 1
    # 1,600 picks over ten deciles of the stream: about 160 each
    assert min(counts) > 110 and max(counts) < 210
