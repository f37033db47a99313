"""Import hygiene of the PyTorch port, its CPU dispatch rule, and where its
entry points put their results.

Importing any libhpc_tpu_torch module must pull in no jax, jaxlib or
triton, must build nothing and must touch no CUDA state. On CPU tensors
each kernel wrapper runs its plain version and leaves its launch counter at
0. Builders and numpy inputs given no device aim at the card: where there
is none they raise rather than run on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.ops import far_sbell, sellp, spmv_dia, spmv_sbell
from libhpc_tpu_torch.ops import spmv_sell
from libhpc_tpu_torch.sparse import DIA
from libhpc_tpu_torch.sparse.sbell import B, W_PANES, SBELL, FarPane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "libhpc_tpu_torch",
    "libhpc_tpu_torch.sparse",
    "libhpc_tpu_torch.sparse._leaves",
    "libhpc_tpu_torch.sparse.csr",
    "libhpc_tpu_torch.sparse.sbell",
    "libhpc_tpu_torch.sparse.dia",
    "libhpc_tpu_torch.sparse.ell",
    "libhpc_tpu_torch.sparse.auto",
    "libhpc_tpu_torch.ops",
    "libhpc_tpu_torch.ops._cuda_utils",
    "libhpc_tpu_torch.ops.spmv",
    "libhpc_tpu_torch.ops.solver",
    "libhpc_tpu_torch.ops.spmv_sbell",
    "libhpc_tpu_torch.ops.far_sbell",
    "libhpc_tpu_torch.ops.spmv_dia",
    "libhpc_tpu_torch.ops.spmv_sell",
    "libhpc_tpu_torch.ops.sellp",
    "libhpc_tpu_torch.ops.histogram",
    "libhpc_tpu_torch.ops.sort",
    "libhpc_tpu_torch.ops.sort_merge",
    "libhpc_tpu_torch.ops.sort_merge_kv",
    "libhpc_tpu_torch.ops.scan",
    "libhpc_tpu_torch.ops.reduce",
    "libhpc_tpu_torch.ops.transpose",
    "libhpc_tpu_torch.ops.matmul",
    "libhpc_tpu_torch.ops.stencil",
    "libhpc_tpu_torch.containers",
    "libhpc_tpu_torch.sparse.grid",
    "libhpc_tpu_torch.utils",
    "libhpc_tpu_torch.utils.morton",
    "libhpc_tpu_torch.bench",
    "libhpc_tpu_torch.bench.matrices",
    "libhpc_tpu_torch.bench.harness",
    "libhpc_tpu_torch.bench.overlap_chip",
    "libhpc_tpu_torch.bench.microarch",
]


def test_modules_listed_are_all_modules():
    pkg = os.path.join(REPO, "libhpc_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                found.add(mod[:-len(".__init__")]
                          if mod.endswith(".__init__") else mod)
    assert found == set(MODULES)


def test_import_pulls_in_no_jax_triton_or_build():
    code = textwrap.dedent(f"""
        import importlib, os, sys
        build = os.path.join({REPO!r}, "libhpc_tpu_torch", "_build")
        before = os.path.exists(build)
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = sorted(m for m in ("jax", "jaxlib", "triton")
                     if m in sys.modules)
        assert not bad, bad
        assert os.path.exists(build) == before, "import created _build/"
        from libhpc_tpu_torch.ops import _cuda_utils
        assert _cuda_utils._LIB is None
        import torch
        assert not torch.cuda.is_initialized(), "import touched CUDA"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    monkeypatch.setattr(spmv_sbell, "NEAR_LAUNCHES", 0)
    monkeypatch.setattr(spmv_sbell, "SPMV_LAUNCHES", 0)
    monkeypatch.setattr(far_sbell, "FAR_LAUNCHES", 0)
    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=9,
                              half_band=5, far_fraction=0.05)
    sb = SBELL.from_scipy(A, device="cpu")
    assert isinstance(sb.far, FarPane)
    xpad = np.linspace(-1, 1, sb.n_panes * 1024).astype(np.float32)
    x3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(xpad))
    guarded = (sb.n_stripes + W_PANES - 1) * B
    near = spmv_sbell.near_out_panes(sb, x3)
    assert torch.equal(near, spmv_sbell.near_out_panes_torch(sb, x3))
    far = far_sbell.far_pane_out_panes(sb.far, x3, guarded)
    assert torch.equal(far, far_sbell.far_pane_out_panes_torch(sb.far, x3,
                                                               guarded))
    y = spmv_sbell.sbell_spmv(sb, torch.from_numpy(xpad[:A.shape[1]]))
    np.testing.assert_allclose(y.numpy(), A @ xpad[:A.shape[1]], rtol=1e-4,
                               atol=1e-4)
    assert spmv_sbell.NEAR_LAUNCHES == 0
    assert spmv_sbell.SPMV_LAUNCHES == 0
    assert far_sbell.FAR_LAUNCHES == 0


def test_cpu_tensors_take_the_plain_path_spmv_family(monkeypatch):
    """K4-K7's wrappers on CPU tensors equal their plain versions and
    leave their launch counters at 0."""
    for mod, name in ((spmv_dia, "DIA_LAUNCHES"), (spmv_dia, "PROBE_LAUNCHES"),
                      (spmv_sell, "SELL_LAUNCHES"), (sellp, "SELLP_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    A = matrices.poisson2d(64)
    x = torch.from_numpy(np.linspace(-1, 1, A.shape[1]).astype(np.float32))
    dp = DIA.from_scipy(A, device="cpu").to_pallas(T=1 << 12)
    x_ext = spmv_dia.extend_x(dp, x)
    assert torch.equal(spmv_dia.dia_out(dp, x_ext),
                       spmv_dia.dia_out_torch(dp, x_ext))
    assert torch.equal(spmv_dia.dia_probe_out(dp, x_ext),
                       spmv_dia.dia_probe_out_torch(dp, x_ext))
    sp = spmv_sell.sell_from_scipy(A, device="cpu")
    x3 = spmv_sell.x_panes(x, sp.n_panes, sp.W - 1)
    assert torch.equal(spmv_sell.sell_out_panes(sp, x3),
                       spmv_sell.sell_out_panes_torch(sp, x3))
    spp = sellp.sellp_from_scipy(A, device="cpu")
    x3p = spmv_sell.x_panes(x, spp.n_panes)
    assert torch.equal(sellp.sellp_out_panes(spp, x3p),
                       sellp.sellp_out_panes_torch(spp, x3p))
    spmv_dia.dia_spmv_pallas(dp, x)
    spmv_sell.sell_spmv(sp, x)
    sellp.sellp_spmv(spp, x)
    assert (spmv_dia.DIA_LAUNCHES, spmv_dia.PROBE_LAUNCHES,
            spmv_sell.SELL_LAUNCHES, sellp.SELLP_LAUNCHES) == (0, 0, 0, 0)


def test_cpu_tensors_take_the_plain_path_sort(monkeypatch):
    """K8-K10's and K15's wrappers on CPU tensors equal their plain
    versions and leave their launch counters at 0."""
    from libhpc_tpu_torch.ops import histogram, sort_merge as sm

    for mod, name in ((sm, "CHUNK_LAUNCHES"), (sm, "MERGE_LAUNCHES"),
                      (sm, "PAIR_LAUNCHES"), (histogram, "HIST_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, size=1 << 13, dtype=np.uint32).view(np.int32))
    kw = dict(log2c=10, alternate=True, invert=False, unflip=False)
    runs = sm.chunk_sort_kernel(x, 16, 100, **kw)
    assert torch.equal(runs[16:80], sm._chunk_sort_torch(x, 16, 100,
                                                         **kw)[16:80])
    merged = sm._merge_level(runs, 1 << 13, 2048, 100, 10, 10, False, False)
    assert torch.equal(merged[16:80], sm._merge_level_torch(
        runs, 1 << 13, 2048, 100, 10, 10, False, False)[16:80])
    sm.merge_sort_u32(x[:5000], log2c=10, log2w=11)
    h = histogram.histogram_pallas(x & 255, 256)
    assert torch.equal(h, histogram.histogram_pallas_torch(x & 255, 256))
    assert (sm.CHUNK_LAUNCHES, sm.MERGE_LAUNCHES, sm.PAIR_LAUNCHES,
            histogram.HIST_LAUNCHES) == (0, 0, 0, 0)


def test_cpu_tensors_take_the_plain_path_kv_and_scan(monkeypatch):
    """K11-K14's wrappers on CPU tensors equal their plain versions and
    leave their launch counters at 0."""
    from libhpc_tpu_torch.ops import scan, sort_merge_kv as kv

    for mod, name in ((kv, "CHUNK_LAUNCHES"), (kv, "MERGE_LAUNCHES"),
                      (kv, "PAIR_LAUNCHES"), (scan, "SCAN_F32_LAUNCHES"),
                      (scan, "SCAN_INT_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.permutation(1 << 13).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, 100, 1 << 13).astype(np.int32))
    kw = dict(log2c=10, alternate=True, invert=False, unflip=False)
    rk, rv = kv.chunk_sort_kv_kernel(x, v, 16, 100, **kw)
    pk, pv = kv._chunk_sort_kv_torch(x, v, 16, 100, **kw)
    assert torch.equal(rk[16:80], pk[16:80])
    assert torch.equal(rv[16:80], pv[16:80])
    mk, mv = kv._merge_level_kv(rk, rv, 1 << 13, 2048, 100, 10, 10, False,
                                False)
    wk, wv = kv._merge_level_kv_torch(rk, rv, 1 << 13, 2048, 100, 10, 10,
                                      False, False)
    assert torch.equal(mk[16:80], wk[16:80])
    assert torch.equal(mv[16:80], wv[16:80])
    kv.merge_sort_kv_u32(x[:5000], v[:5000], log2c=10, log2w=11)
    f = torch.from_numpy(rng.random(5000).astype(np.float32))
    assert torch.equal(scan.exclusive_scan_pallas(f),
                       scan._exclusive_scan_f32_torch(f))
    assert torch.equal(scan.exclusive_scan_pallas(v),
                       scan._exclusive_scan_int_torch(v))
    assert (kv.CHUNK_LAUNCHES, kv.MERGE_LAUNCHES, kv.PAIR_LAUNCHES,
            scan.SCAN_F32_LAUNCHES, scan.SCAN_INT_LAUNCHES) == (0,) * 5


def test_cpu_tensors_take_the_plain_path_dense_layer(monkeypatch):
    """K16-K19's wrappers on CPU tensors equal their plain versions and
    leave their launch counters at 0; transpose() on a CPU tensor never
    reaches K17's wrapper."""
    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import reduce as red
    from libhpc_tpu_torch.ops import stencil
    from libhpc_tpu_torch.ops import transpose as tr

    for mod, name in ((red, "ROW_SUM_LAUNCHES"), (tr, "TRANSPOSE_LAUNCHES"),
                      (mm, "MATMUL_LAUNCHES"), (stencil, "BLUR_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1024, 2048)).astype(np.float32))
    assert torch.equal(red.row_sum_pallas(x), red.row_sum_pallas_torch(x))
    assert torch.equal(tr.transpose_pallas(x), tr.transpose_pallas_torch(x))
    assert torch.equal(tr.transpose(x), x.t())
    a, b = x[:100, :300], x[300:600, :50]
    assert torch.equal(mm.matmul_pallas(a, b), mm.matmul_pallas_torch(a, b))
    assert torch.equal(stencil.blur2d_pallas(x[:200, :300]),
                       stencil.blur2d_pallas_torch(x[:200, :300]))
    assert (red.ROW_SUM_LAUNCHES, tr.TRANSPOSE_LAUNCHES, mm.MATMUL_LAUNCHES,
            stencil.BLUR_LAUNCHES) == (0, 0, 0, 0)


def test_cpu_tensors_take_the_plain_path_microarch(monkeypatch):
    """K20's and K21a-d's wrappers on CPU tensors equal their plain
    versions, never reach a kernel entry point, and leave their launch
    counters at 0."""
    from libhpc_tpu_torch.bench import microarch as ma
    from libhpc_tpu_torch.bench import overlap_chip as oc

    def no_kernel(*_):
        raise AssertionError("a CPU tensor reached a kernel entry point")

    for mod in (ma, oc):
        monkeypatch.setattr(mod, "kernel_fn", no_kernel)
    for mod, name in ((oc, "SWEEP_LAUNCHES"), (ma, "LANE_SHUFFLE_LAUNCHES"),
                      (ma, "DMA_GATHER_LAUNCHES"),
                      (ma, "CMPEX_ROLL_LAUNCHES"),
                      (ma, "CMPEX_RESHAPE_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2 * 2048, 128), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, 128, (96, 128), dtype=np.int32))
    rows = torch.from_numpy(rng.integers(0, 24, 40, dtype=np.int32))
    assert torch.equal(oc._sweep_step(x, 3), oc._sweep_step_torch(x, 3))
    assert torch.equal(ma.lane_shuffle(x[:32], idx),
                       ma.lane_shuffle_torch(x[:32], idx))
    assert torch.equal(ma.dma_gather(rows, x[:72], 3, 5),
                       ma.dma_gather_torch(rows, x[:72], 3))
    assert torch.equal(ma.cmpex_roll(x), ma.cmpex_roll_torch(x))
    assert torch.equal(ma.cmpex_reshape(x), ma.cmpex_reshape_torch(x))
    assert (oc.SWEEP_LAUNCHES, ma.LANE_SHUFFLE_LAUNCHES,
            ma.DMA_GATHER_LAUNCHES, ma.CMPEX_ROLL_LAUNCHES,
            ma.CMPEX_RESHAPE_LAUNCHES) == (0,) * 5


def _aims_at_the_card(fn):
    """fn() with no device given must aim at "cuda": on a machine without
    a card it raises (torch's "not compiled with CUDA" or "no CUDA GPUs"),
    and never returns a result computed on the CPU."""
    if torch.cuda.is_available():
        out = fn()
        dev = out[0].device if isinstance(out, tuple) else out.device
        assert dev.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        fn()


def _builders():
    from libhpc_tpu_torch.sparse import CSR, ELL, auto

    A = matrices.poisson2d(32)
    dia_cpu = DIA.from_scipy(A, device="cpu")
    ell_cpu = ELL.from_scipy(A, device="cpu")
    from libhpc_tpu_torch.sparse import BlockGrid, NestedGrid

    return {
        "BlockGrid.create": lambda: BlockGrid.create((4, 4), 8, 16),
        "NestedGrid.create": lambda: NestedGrid.create((2, 2), (2, 2), 8),
        "CSR.from_scipy": lambda: CSR.from_scipy(A),
        "CSR.from_dense": lambda: CSR.from_dense(A.toarray()),
        "SBELL.from_scipy": lambda: SBELL.from_scipy(A),
        "DIA.from_scipy": lambda: DIA.from_scipy(A),
        "ELL.from_scipy": lambda: ELL.from_scipy(A),
        "auto_format": lambda: auto.auto_format(A),
        "sell_from_ell": lambda: spmv_sell.sell_from_ell(ell_cpu),
        "sell_from_scipy": lambda: spmv_sell.sell_from_scipy(A),
        "sellp_from_scipy": lambda: sellp.sellp_from_scipy(A),
        "DiaPallas.from_dia": lambda: spmv_dia.DiaPallas.from_dia(
            dia_cpu, T=1 << 12),
    }


BUILDERS = ["BlockGrid.create", "NestedGrid.create", "CSR.from_scipy", "CSR.from_dense", "SBELL.from_scipy",
            "DIA.from_scipy", "ELL.from_scipy", "auto_format",
            "sell_from_ell", "sell_from_scipy", "sellp_from_scipy",
            "DiaPallas.from_dia"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_default_to_the_card(name):
    _aims_at_the_card(_builders()[name])


def _numpy_ops():
    from libhpc_tpu_torch.ops import scan, sort, sort_merge
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    x = np.random.default_rng(1).integers(0, 2**32, 3000, dtype=np.uint32)
    return {
        "u32_bits": lambda: sort.u32_bits(x),
        "is_sorted": lambda: sort.is_sorted(x),
        "sort_u32": lambda: sort.sort_u32(x),
        "merge_sort_u32": lambda: sort_merge.merge_sort_u32(x, 10, 11),
        "merge_sort_kv_u32": lambda: kv.merge_sort_kv_u32(x, x, 10, 11),
        "merge_argsort_u32": lambda: kv.merge_argsort_u32(x, 10, 11),
        "exclusive_scan": lambda: scan.exclusive_scan(x),
        "inclusive_scan": lambda: scan.inclusive_scan(x),
        "exclusive_scan_pallas": lambda: scan.exclusive_scan_pallas(x),
        **_dense_layer_ops(),
    }


def _dense_layer_ops():
    from libhpc_tpu_torch.containers import HaloArray
    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import reduce as red
    from libhpc_tpu_torch.ops import stencil
    from libhpc_tpu_torch.ops import transpose as tr
    from libhpc_tpu_torch.utils import morton

    a = np.random.default_rng(2).random((40, 24)).astype(np.float32)
    ids = np.arange(40) % 3
    c = np.arange(16, dtype=np.uint32)
    return {
        "row_sum_pallas": lambda: red.row_sum_pallas(a),
        "tree_reduce_sum": lambda: red.tree_reduce_sum(a),
        "segment_sum": lambda: red.segment_sum(a, ids, 3),
        "segment_max": lambda: red.segment_max(a, ids, 3),
        "segment_min": lambda: red.segment_min(a, ids, 3),
        "transpose_pallas": lambda: tr.transpose_pallas(a),
        "transpose": lambda: tr.transpose(a),
        "matmul_pallas": lambda: mm.matmul_pallas(a, a.T),
        "blur2d_pallas": lambda: stencil.blur2d_pallas(a, 2),
        "blur_x": lambda: stencil.blur_x(a, 2),
        "blur2d": lambda: stencil.blur2d(a, 2),
        "box_sum_1d": lambda: stencil.box_sum_1d(a, 2, 0),
        "poisson5_apply": lambda: stencil.poisson5_apply(a),
        "poisson7_apply": lambda: stencil.poisson7_apply(a[:8, :8, None]),
        "HaloArray.wrap": lambda: HaloArray.wrap(a, 1),
        "HaloArray.from_padded": lambda: HaloArray.from_padded(a, 1),
        "morton2d_encode": lambda: morton.morton2d_encode(c, c),
        "morton2d_decode": lambda: morton.morton2d_decode(c),
        "morton3d_encode": lambda: morton.morton3d_encode(c, c, c),
        "morton3d_decode": lambda: morton.morton3d_decode(c),
    }


NUMPY_OPS = ["u32_bits", "is_sorted", "sort_u32", "merge_sort_u32",
             "merge_sort_kv_u32", "merge_argsort_u32", "exclusive_scan",
             "inclusive_scan", "exclusive_scan_pallas", "row_sum_pallas",
             "tree_reduce_sum", "segment_sum", "segment_max", "segment_min",
             "transpose_pallas", "transpose", "matmul_pallas",
             "blur2d_pallas", "blur_x", "blur2d", "box_sum_1d",
             "poisson5_apply", "poisson7_apply", "HaloArray.wrap",
             "HaloArray.from_padded", "morton2d_encode", "morton2d_decode",
             "morton3d_encode", "morton3d_decode"]


@pytest.mark.parametrize("name", NUMPY_OPS)
def test_numpy_inputs_default_to_the_card(name):
    _aims_at_the_card(_numpy_ops()[name])


def test_torch_tensors_stay_on_their_device():
    from libhpc_tpu_torch.ops import scan, sort_merge_kv as kv

    x = torch.arange(3000, dtype=torch.int32).flip(0)
    s, order = kv.merge_argsort_u32(x, 10, 11)
    assert s.device.type == order.device.type == "cpu"
    assert scan.exclusive_scan_pallas(x).device.type == "cpu"
    assert torch.equal(order, torch.arange(3000, dtype=torch.int32).flip(0))


BENCHES = ["gather_row_width", "scatter_modes", "lane_shuffle", "dma_gather",
           "roll_vs_reshape", "overlap_chip.run"]


@pytest.mark.parametrize("name", BENCHES)
def test_benches_default_to_the_card(name):
    """Every bench given no device runs on the card: without one it raises
    before it measures anything."""
    from libhpc_tpu_torch.bench import microarch as ma
    from libhpc_tpu_torch.bench import overlap_chip as oc

    small = {"gather_row_width": dict(n_rows=256, m=256),
             "scatter_modes": dict(n=4096),
             "lane_shuffle": dict(S=8, n_tiles=2),
             "dma_gather": dict(n_table=16, n_gather=32, R=8, G=8),
             "roll_vs_reshape": dict(rows=8)}
    fn = (lambda: oc.run(mb=2)) if name == "overlap_chip.run" else (
        lambda: ma.ALL[name](**small[name]))
    if torch.cuda.is_available():
        fn()
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        fn()


def test_ptxas_usage_reads_the_nvcc_report(tmp_path, monkeypatch):
    """ptxas_usage runs nvcc -Xptxas -v on each named source and maps each
    kernel to its registers and spilled bytes (here a stand-in nvcc that
    prints a report of two kernels, one of them spilling)."""
    from libhpc_tpu_torch.ops import _cuda_utils

    report = textwrap.dedent("""\
        ptxas info    : 0 bytes gmem
        ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
        ptxas info    : Function properties for _Z3fooPf
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 125 registers, used 1 barriers, 400 bytes cmem[0]
        ptxas info    : Compiling entry function '_Z3barPi' for 'sm_90a'
        ptxas info    : Function properties for _Z3barPi
            8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
        ptxas info    : Used 40 registers, 17408 bytes smem, 384 bytes cmem[0]
        """)
    (tmp_path / "report.txt").write_text(report)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"sys.stderr.write(open({str(tmp_path / 'report.txt')!r})"
                    ".read())\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda_utils, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda_utils, "BUILD_DIR", tmp_path / "build")
    got = _cuda_utils.ptxas_usage("matmul.cu")
    assert got == {
        "_Z3fooPf": {"registers": 125, "spill_stores": 0, "spill_loads": 0},
        "_Z3barPi": {"registers": 40, "spill_stores": 12, "spill_loads": 16}}
