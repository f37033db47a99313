"""The port's utilities against libhpc_tpu's on the CPU: the configs
(utils/config.py), validation (utils/validate.py), checkpoints
(utils/checkpoint.py), profiling (utils/profiling.py) and the SpMV byte
models of bench/harness.py, on the cases of the reference's
tests/test_utils_aux.py and more.

Agreement: the same inputs raise the same errors with the same messages;
checkpoints of either package restore in the port leaf for leaf (and the
port's in the reference); a CG resumed from a checkpoint equals one
resumed from the live state at the reference test's rtol 1e-6; the byte
counts equal the reference's integer for integer.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import harness as ref_harness
from libhpc_tpu.bench.matrices import block_random, poisson2d
from libhpc_tpu.sparse import CSR as RefCSR
from libhpc_tpu.utils import checkpoint as ref_checkpoint
from libhpc_tpu.utils import config as ref_config
from libhpc_tpu.utils import validate as ref_validate
from libhpc_tpu_torch.bench import harness
from libhpc_tpu_torch.sparse import CSR
from libhpc_tpu_torch.utils import checkpoint, config, profiling, validate

from _torch_port import assert_same_container, port_of
from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# -- config ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(tile_m=128, tile_n=256),
                                dict(tile_m=100), dict(tile_n=0),
                                dict(tile_n=-8), dict(lane=64)])
def test_kernel_config_rules_match_reference(kw):
    try:
        want = ref_config.KernelConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            config.KernelConfig(**kw)
        assert str(got.value) == str(e)
    else:
        assert dataclasses.asdict(config.KernelConfig(**kw)) == \
            dataclasses.asdict(want)


@pytest.mark.parametrize("bits", [4, 5, 8, 16, 32])
def test_radix_config_rules_match_reference(bits):
    try:
        want = ref_config.RadixConfig(bits_per_pass=bits)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            config.RadixConfig(bits_per_pass=bits)
        assert str(got.value) == str(e)
    else:
        got = config.RadixConfig(bits_per_pass=bits)
        assert (got.n_bins, got.n_passes) == (want.n_bins, want.n_passes)
    assert config.RadixConfig().n_bins == 256
    assert config.RadixConfig().n_passes == 4


def test_config_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.KernelConfig().tile_m = 8


# -- validate --------------------------------------------------------------

DENSE = np.array([[1, 0, 2], [0, 0, 0], [3, 4, 0]], np.float32)

# corruptions of the good CSR (field, position, value) and the message the
# host validator raises for each
BAD = {
    "column_index": ("indices", 0, 99, "column index out of range"),
    "negative_index": ("indices", 2, -1, "column index out of range"),
    "indptr_not_monotone": ("indptr", 1, 5, "indptr not monotone"),
    "indptr_start": ("indptr", 0, 1, "indptr[0] != 0"),
    "indptr_end": ("indptr", 3, 9, "indptr[-1] > nnz"),
}


def _corrupt(csr, field, pos, value):
    leaf = getattr(csr, field)
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.clone()
        leaf[pos] = value
    else:
        leaf = leaf.at[pos].set(value)
    return dataclasses.replace(csr, **{field: leaf})


def test_validate_good_csr():
    csr = CSR.from_dense(DENSE, device="cpu")
    validate.validate_csr(csr)
    err, out = validate.csr_invariants_checked(csr)
    assert out == () and err.get() is None
    err.throw()  # no violation


@pytest.mark.parametrize("name", sorted(BAD))
def test_validate_corrupted_csr_matches_reference(name):
    field, pos, value, msg = BAD[name]
    port = _corrupt(CSR.from_dense(DENSE, device="cpu"), field, pos, value)
    ref = _corrupt(RefCSR.from_dense(DENSE), field, pos, value)
    with pytest.raises(ValueError) as want:
        ref_validate.validate_csr(ref)
    with pytest.raises(ValueError) as got:
        validate.validate_csr(port)
    assert str(got.value) == str(want.value) == msg
    # the checked form: the reference's checkify error names the first
    # failed check; the port's err does too
    ref_err, _ = ref_validate.csr_invariants_checked(ref)
    err, _ = validate.csr_invariants_checked(port)
    assert err.get() is not None and ref_err.get() is not None
    assert err.get() in ref_err.get()
    with pytest.raises(ValueError, match=err.get().replace("[", r"\[")):
        err.throw()


def test_debug_nans():
    x = torch.tensor([0.0, 1.0])
    validate.debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match="nan"):
            torch.div(x, x)
        assert float((x + 1).sum()) == 3.0      # finite results pass
    finally:
        validate.debug_nans(False)
    assert torch.isnan(torch.div(x, x)[0])      # off again


# -- checkpoint ------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"x": torch.arange(10.0), "it": torch.tensor(7, dtype=torch.int32),
             "nested": (torch.ones((3, 3)),)}
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save(p, state)
    back = checkpoint.restore(p, state)
    np.testing.assert_allclose(back["x"].numpy(), np.arange(10.0))
    assert int(back["it"]) == 7 and back["it"].dtype == torch.int32
    np.testing.assert_allclose(back["nested"][0].numpy(), np.ones((3, 3)))
    assert isinstance(back["nested"], tuple) and list(back) == list(state)


def _ref_state():
    return {"x": jnp.arange(10.0), "it": jnp.int32(7),
            "nested": (jnp.ones((3, 3)), [jnp.arange(4), None]),
            "b": jnp.asarray([1.5, -2.0], jnp.bfloat16)}


def _port_state():
    return {"x": torch.zeros(10), "it": torch.tensor(0, dtype=torch.int32),
            "nested": (torch.zeros((3, 3)),
                       [torch.zeros(4, dtype=torch.int32), None]),
            "b": torch.zeros(2, dtype=torch.bfloat16)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's .npz restores into the port's structure leaf for
    leaf, in the dtypes of the port's template; the port's file has the
    same layout and restores in the reference."""
    ref_path = str(tmp_path / "ref.npz")
    ref_checkpoint.save(ref_path, _ref_state())
    back = checkpoint.restore(ref_path, _port_state())
    np.testing.assert_array_equal(back["x"].numpy(), np.arange(10.0))
    assert int(back["it"]) == 7
    np.testing.assert_array_equal(back["nested"][0].numpy(), np.ones((3, 3)))
    np.testing.assert_array_equal(back["nested"][1][0].numpy(), np.arange(4))
    assert back["nested"][1][1] is None
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["b"].float().numpy(), [1.5, -2.0])

    port_path = str(tmp_path / "port.npz")
    checkpoint.save(port_path, back)
    with np.load(ref_path) as r, np.load(port_path) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            if k != "__treedef__" and k != "leaf_0":    # "b": bf16 bits
                np.testing.assert_array_equal(p[k], r[k])
    again = ref_checkpoint.restore(port_path, _ref_state())
    np.testing.assert_array_equal(np.asarray(again["nested"][0]),
                                  np.ones((3, 3)))
    assert int(again["it"]) == 7


def test_checkpoint_of_containers(tmp_path):
    """Containers are flattened in field order, as the reference's
    pytrees: a reference CSR and SBELL (FarPane) restore into the port's
    containers array by array."""
    from libhpc_tpu.sparse.sbell import SBELL as RefSBELL

    A = block_random(64, block=8, blocks_per_row=6, seed=3,
                     far_fraction=0.3)
    ref = {"csr": RefCSR.from_scipy(A), "sb": RefSBELL.from_scipy(A)}
    sb = port_of(ref["sb"])
    csr = port_of(ref["csr"])
    like = {"csr": dataclasses.replace(csr, data=torch.zeros_like(csr.data)),
            "sb": sb}
    p = str(tmp_path / "containers.npz")
    ref_checkpoint.save(p, ref)
    back = checkpoint.restore(p, like)
    assert type(sb.far).__name__ == "FarPane"
    assert_same_container(back["csr"], ref["csr"])
    assert_same_container(back["sb"], ref["sb"])
    assert torch.equal(back["sb"].tile_ptr, sb.tile_ptr)
    assert torch.equal(back["sb"].far.olane, sb.far.olane)


def test_checkpoint_solver_state(tmp_path):
    """Resume a CG run mid-flight: save state, restore, same trajectory
    (the reference test's rtol 1e-6)."""
    from libhpc_tpu_torch.ops import solver

    A = poisson2d(8)
    csr = CSR.from_scipy(A, device="cpu")
    b = torch.ones(A.shape[0])
    x1, it1, _ = solver.cg(lambda v: csr @ v, b, tol=1e-10, max_iter=20)
    p = str(tmp_path / "x.npz")
    checkpoint.save(p, x1)
    x1b = checkpoint.restore(p, x1)
    assert torch.equal(x1b, x1)
    x2a, _, _ = solver.cg(lambda v: csr @ v, b, x0=x1, tol=1e-10,
                          max_iter=20)
    x2b, _, _ = solver.cg(lambda v: csr @ v, b, x0=x1b, tol=1e-10,
                          max_iter=20)
    np.testing.assert_allclose(x2a.numpy(), x2b.numpy(), rtol=1e-6)


def test_checkpoint_path_without_suffix(tmp_path):
    p = str(tmp_path / "sub" / "state")
    checkpoint.save(p, [torch.arange(3)])
    assert os.path.exists(p + ".npz")
    assert torch.equal(checkpoint.restore(p, [torch.zeros(3,
                                                          dtype=torch.long)])[0],
                       torch.arange(3))


# -- profiling -------------------------------------------------------------

def test_annotate_and_wall_timer():
    """annotate alone (the port has no wall_timer): one shared no-op
    context while nothing records, a named range while a profiler does."""
    off = profiling.annotate("stage_double")
    assert off is profiling.annotate("unrecorded")
    with off:
        y = torch.tensor(2.0) * 2
    assert float(y) == 4.0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = profiling.annotate("stage_double")
        assert on is not off
        with on:
            y = torch.tensor(2.0) * 2
    assert float(y) == 4.0
    assert "stage_double" in {e.name for e in prof.events()}
    assert profiling.annotate("stage_double") is off


def test_trace_to_names_the_range(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace_to(logdir):
        with profiling.annotate("stage_double"):
            torch.ones(64).mul(2).sum()
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "stage_double" for e in events)


# -- byte models -----------------------------------------------------------

def _byte_cases():
    from libhpc_tpu.sparse import BELL, DIA, ELL
    from libhpc_tpu.sparse.sbell import SBELL

    far = block_random(64, block=8, blocks_per_row=6, seed=3,
                       far_fraction=0.3)
    spread = sps.random(3000, 3000, density=0.002, format="csr",
                        dtype=np.float32, random_state=5)
    P = poisson2d(24)
    return {"csr": ("csr", RefCSR.from_scipy(far), far.shape),
            "ell": ("ell", ELL.from_scipy(P), P.shape),
            "dia": ("dia", DIA.from_scipy(P), P.shape),
            "bell": ("bell", BELL.from_scipy(far, block=8), far.shape),
            "sbell_farpane": ("sbell", SBELL.from_scipy(far), far.shape),
            "sbell_farblocks": ("sbell", SBELL.from_scipy(far,
                                                          group_far=False),
                                far.shape),
            "sbell_spread": ("sbell", SBELL.from_scipy(spread),
                             spread.shape)}


@pytest.mark.parametrize("name", sorted(_byte_cases()))
def test_byte_models_match_reference(name):
    fmt, ref, (m, n) = _byte_cases()[name]
    port = port_of(ref)
    if name.startswith("sbell"):
        kind = {"sbell_farpane": "FarPane",
                "sbell_farblocks": "FarBlocks"}.get(name)
        assert kind is None or type(port.far).__name__ == kind
    got = harness.format_spmv_bytes(fmt, port, m, n)
    want = ref_harness.format_spmv_bytes(fmt, ref, m, n)
    assert type(got) is int and got == want
    assert harness.format_spmv_rw_bytes(fmt, port, m, n) == \
        ref_harness.format_spmv_rw_bytes(fmt, ref, m, n)


def test_byte_model_helpers_match_reference():
    for args in ((100, 10, 12), (3_120_000, 62_000, 62_000, 2, 4)):
        assert harness.spmv_bytes(*args) == ref_harness.spmv_bytes(*args)
    for args in ((3.0e12, 2.9e12, 90, 10), (2.0e12, 3.0e12, 5, 95)):
        assert harness.mixed_speed_of_light(*args) == \
            ref_harness.mixed_speed_of_light(*args)
    with pytest.raises(KeyError):
        harness.format_spmv_bytes("coo", None, 1, 1)
    kw = dict(metric="spmv", value=1.5, unit="ms", vs_baseline=0.5,
              extra={"nnz": 7})
    assert harness.BenchResult(**kw).json_line() == \
        ref_harness.BenchResult(**kw).json_line()


def test_bench_spmv_square_on_the_cpu():
    A = poisson2d(16)
    csr = CSR.from_scipy(A, device="cpu")
    x0 = torch.ones(A.shape[0])
    r = harness.bench_spmv_square(lambda v: csr @ v * 0.125, x0, A.nnz,
                                  *A.shape, hbm_bytes_per_s=1e10, iters=8)
    assert set(r) == {"seconds", "gflops", "nnz_per_s",
                      "achieved_bytes_per_s", "roofline_fraction"}
    assert r["seconds"] > 0
    assert r["achieved_bytes_per_s"] == pytest.approx(
        harness.spmv_bytes(A.nnz, *A.shape) / r["seconds"])
