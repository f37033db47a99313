"""The port's micro-architecture suites (libhpc_tpu_torch/bench/microarch.py,
overlap_chip.py, harness.py) against libhpc_tpu/bench/microarch.py and
overlap_chip.py (CPU; the reference's Pallas kernels in interpret mode, the
port's plain versions).

The kernels' outputs must equal the reference's exactly (K21a-d move or
compare values and add nothing); K20 sums 256 rows a block in another
order, so it is held at rtol/atol 1e-3 (tests/test_microarch.py). Every
bench emits the reference's JSON keys at tests/test_microarch.py's sizes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhpc_tpu.bench import microarch as ref
from libhpc_tpu.bench import overlap_chip as ref_overlap
from libhpc_tpu_torch.bench import harness, microarch, overlap_chip

# tests/test_microarch.py's sizes
SIZES = {
    "gather_row_width": dict(n_rows=256, m=256),
    "scatter_modes": dict(n=4096),
    "lane_shuffle": dict(S=8, n_tiles=2),
    "dma_gather": dict(n_table=16, n_gather=32, R=8, G=8),
    "roll_vs_reshape": dict(rows=8),
}


@pytest.mark.parametrize("w", [0, 2, 64])
def test_sweep_step_matches_reference(rng, w):
    """K20 on 2 x 2048 rows. The input is scaled by 1 / (w + 1): acc grows
    to about (w + 1) v, and at O(1) values atol 1e-3 bounds the float32
    rounding of the 256-row fold in either order."""
    x = (rng.standard_normal((2 * overlap_chip.ROWS, overlap_chip.LANE))
         / (w + 1)).astype(np.float32)
    got = overlap_chip._sweep_step(torch.from_numpy(x), w)
    assert got.shape == (16, overlap_chip.LANE) and got.dtype == torch.float32
    want = np.asarray(ref_overlap._sweep_step(jnp.asarray(x), w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_sweep_step_ignores_trailing_rows(rng):
    x = rng.random((overlap_chip.ROWS + 5, overlap_chip.LANE),
                   dtype=np.float32)
    got = overlap_chip._sweep_step(torch.from_numpy(x), 1)
    want = np.asarray(ref_overlap._sweep_step(jnp.asarray(x), 1))
    assert got.shape == want.shape == (8, overlap_chip.LANE)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_constants_match_reference():
    assert (overlap_chip.ROWS, overlap_chip.LANE, overlap_chip.WS) == (
        ref_overlap.ROWS, ref_overlap.LANE, ref_overlap.WS)
    assert list(microarch.ALL) == list(ref.ALL)


def test_lane_shuffle_matches_reference(rng):
    S, n_tiles = 8, 2
    tab = rng.random((S, 128), dtype=np.float32)
    idx = rng.integers(0, 128, (n_tiles * S, 128), dtype=np.int32)
    got = microarch.lane_shuffle(torch.from_numpy(tab), torch.from_numpy(idx))
    want = np.asarray(ref._lane_shuffle_call(S, n_tiles)(jnp.asarray(tab),
                                                         jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    # row r of every tile reads only table row r
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(np.tile(tab, (n_tiles, 1)), idx, 1))


def test_dma_gather_matches_reference(rng):
    n_table, n_gather, R, G = 16, 32, 8, 8
    table = rng.random((n_table * R, 128), dtype=np.float32)
    idx = rng.integers(0, n_table, n_gather, dtype=np.int32)
    got = microarch.dma_gather(torch.from_numpy(idx), torch.from_numpy(table),
                               R, G)
    want = np.asarray(ref._dma_gather_call(n_table * R, n_gather, R, G)(
        jnp.asarray(idx), jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,G,want", [
    (8, 256, (4, 32)),    # the bench's 4 KB gathers: 4 a stage, 4 stages
    (1, 1, (2, 1)),       # one gather in flight: the ring's two stages
    (3, 5, (2, 15)),      # 5 gathers of 3 rows: one stage's worth
    (1, 256, (4, 32)),    # 32 gathers a stage, one copy a lane
    (65, 1, (3, 32)),     # a gather past a stage: 32 rows a stage
    (32, 2, (2, 32))])
def test_gather_plan(R, G, want):
    """K21b's ring: whole gathers a stage where R rows fit (at most 32, one
    copy a lane), a piece of one gather a stage where they do not; never
    more rows in flight than G gathers hold, but two stages at least."""
    stages, rows = microarch.gather_plan(R, G)
    assert (stages, rows) == want
    assert rows % R == 0 if R <= microarch.STAGE_ROWS else rows < R
    assert rows // R <= microarch.DMA_MAX_PIECES
    assert 2 <= stages <= microarch.DMA_MAX_STAGES
    assert stages * rows <= max(G * R + rows, 2 * rows)
    assert microarch.gather_plan(8, 256, stages=8, stage_rows=32) == (8, 32)
    assert microarch.gather_plan(8, 1, stages=8, stage_rows=64) == (2, 8)
    # 8 stages of 32 KB pass the shared memory a block may use: 7 fit
    assert microarch.gather_plan(8, 256, stages=8, stage_rows=64) == (7, 64)
    for bad in (dict(stages=1), dict(stages=9), dict(stage_rows=0)):
        with pytest.raises(ValueError):
            microarch.gather_plan(R, G, **bad)
    with pytest.raises(ValueError):   # two stages of 150 KB do not fit
        microarch.gather_plan(1000, G, stage_rows=300)


@pytest.mark.parametrize("variant", ["roll", "reshape"])
def test_cmpex_matches_reference(rng, variant):
    """Each compare-exchange pass computes its own reference's function."""
    x = rng.random((8, 128), dtype=np.float32)
    port = {"roll": microarch.cmpex_roll,
            "reshape": microarch.cmpex_reshape}[variant]
    maker = {"roll": ref._cmpex_roll_call,
             "reshape": ref._cmpex_reshape_call}[variant]
    got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(maker(8)(jnp.asarray(x))))


def test_cmpex_roll_pairs_lane_2k_with_2k_minus_1(rng):
    """The roll pass pairs even lane 2k with lane 2k - 1 and lane 0 with
    lane 127 (np.roll semantics), not (2k, 2k + 1); the two passes agree
    on the odd lanes only."""
    x = rng.random((8, 128), dtype=np.float32)
    y = np.roll(x, 1, axis=1)
    even = np.arange(128) % 2 == 0
    want = np.where(even, np.minimum(x, y), np.maximum(x, y))
    roll = microarch.cmpex_roll(torch.from_numpy(x)).numpy()
    reshape = microarch.cmpex_reshape(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(roll, want)
    np.testing.assert_array_equal(roll[:, 0], np.minimum(x[:, 0], x[:, 127]))
    np.testing.assert_array_equal(roll[:, ~even], reshape[:, ~even])
    assert not np.array_equal(roll[:, even], reshape[:, even])


def _json_lines(capsys):
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("name", list(SIZES))
def test_bench_emits_the_reference_keys(capsys, name):
    ref.ALL[name](**SIZES[name])
    want = _json_lines(capsys)
    microarch.ALL[name](**SIZES[name], device="cpu")
    got = _json_lines(capsys)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert "error" not in g, g
        assert g["bench"] == w["bench"] == name
        extra = ({"stages", "stage_rows", "rows_in_flight_per_block"}
                 if name == "dma_gather" else set())
        assert set(g) == set(w) | extra
        for k in ("b", "mode", "variant", "table_rows", "rows_per_dma",
                  "in_flight"):
            assert g.get(k) == w.get(k), k
        # rates are rounded to 4 decimals, as the reference's are: a slow
        # CPU run may round one to 0
        assert all(v >= 0 for k, v in g.items() if k.startswith("g_"))


def test_main_reports_an_error_line(capsys, monkeypatch):
    def boom(**_):
        raise RuntimeError("no card")

    monkeypatch.setitem(microarch.ALL, "lane_shuffle", boom)
    microarch.main(["lane_shuffle"])
    assert _json_lines(capsys) == [
        {"bench": "lane_shuffle", "error": "RuntimeError: no card"}]


def test_overlap_run_emits_the_reference_keys(capsys):
    out = overlap_chip.run(mb=2, device="cpu")
    assert _json_lines(capsys) == [out]
    assert set(out) == {"bench", "block_mb", "stream_gb_per_s", "us_per_step",
                        "compute_unit_us", "w_star", "overlap_efficiency",
                        "platform"}
    assert out["bench"] == "singlechip_dma_compute_overlap"
    assert set(out["us_per_step"]) == {str(w) for w in overlap_chip.WS}
    assert out["w_star"] in overlap_chip.WS[1:]
    assert out["platform"] == "cpu"
    assert out["block_mb"] == 2048 * 128 * 4 / 1e6


def test_time_iterated_counts_applications():
    """The delta method divides by the applications between the two chain
    lengths, and each chain starts again from x0."""
    calls = []

    def step(v):
        calls.append(1)
        return v + 1

    x0 = torch.zeros(3)
    per = harness.time_iterated(step, x0, iters=6, iters_small=2, reps=2)
    assert per > 0
    assert len(calls) == (6 + 2) * (1 + 2)
    assert torch.equal(x0, torch.zeros(3))


def test_hbm_probes_run_on_the_cpu():
    assert harness.measure_hbm_bandwidth(1 << 16, device="cpu") > 0
    assert harness.measure_hbm_read_bandwidth(1 << 16, device="cpu") > 0
