"""The port's benchmark corpus (libhpc_tpu_torch/bench/corpus.py) and its
flagship CG step (libhpc_tpu_torch/dryrun.py:entry) against the JAX
reference on the CPU.

The reference's record names, keys and gates are read from
libhpc_tpu/bench/corpus.py with ``ast`` (importing it would run no bench,
but would turn on its compilation cache), f-string names expanded over the
literal loops they sit in. The port's ``main`` then runs every bench at
small sizes with the timing harness replaced by one call of each step and
a fixed time, and must print exactly those records, apart from the two
differences its docstring names. The compositions the corpus builds from
ported ops (the Morton tile transpose, the float32 shifted-Poisson DIA CG,
CG in SBELL pane layout, the bf16 gate, the 100M case's SBELL at small
size, and entry()'s CG step) are held against the reference's, Pallas in
interpret mode.
"""

import ast
import functools
import inspect
import json
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import __graft_entry__ as ref_entry
from libhpc_tpu.ops import solver as ref_solver
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.ops import spmv_pallas as ref_pallas
from libhpc_tpu.sparse import DIA as RefDIA
from libhpc_tpu.sparse.sbell import SBELL as RefSBELL
from libhpc_tpu.utils.morton import morton2d_decode as ref_morton2d_decode
from libhpc_tpu_torch import dryrun
from libhpc_tpu_torch.bench import corpus, harness, matrices
from libhpc_tpu_torch.ops import spmv, spmv_sbell
from libhpc_tpu_torch.sparse.sbell import SBELL, FarPane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CORPUS = os.path.join(REPO, "libhpc_tpu", "bench", "corpus.py")

# the port's record keys that differ from the reference's (module docstring)
DROPPED = {"spmv_sbell_100m_chunked": {"chunked", "n_chunks", "resident_mb",
                                       "vmem_cap_mb"}}
ADDED = {"spmv_sbell_100m_chunked": {"launches"},
         "cg_sbell_cant_32it": {"iters_run"}}


# -- the reference's records, read from its source ---------------------------


def _loop_bindings(node: ast.For):
    """One {name: constant} a pass of a for loop over a literal sequence
    (non-constant items, such as jnp dtypes, are left unbound); None for
    any other loop."""
    if not isinstance(node.iter, (ast.Tuple, ast.List)):
        return None
    out = []
    for elt in node.iter.elts:
        if isinstance(node.target, ast.Name):
            pairs = [(node.target, elt)]
        else:
            pairs = zip(node.target.elts, elt.elts)
        out.append({t.id: e.value for t, e in pairs
                    if isinstance(e, ast.Constant)})
    return out


def _name(expr, env) -> str:
    if isinstance(expr, ast.Constant):
        return expr.value
    return "".join(str(v.value) if isinstance(v, ast.Constant)
                   else str(env[v.value.id]) for v in expr.values)


def _records(stmts, env, out):
    for s in stmts:
        bindings = _loop_bindings(s) if isinstance(s, ast.For) else None
        if bindings is not None:
            for b in bindings:
                _records(s.body, {**env, **b}, out)
            continue
        if isinstance(s, ast.FunctionDef):
            continue
        blocks = [getattr(s, f, []) for f in ("body", "orelse", "finalbody")]
        blocks += [h.body for h in getattr(s, "handlers", [])]
        if any(blocks):
            for blk in blocks:
                _records(blk, env, out)
            continue
        for node in ast.walk(s):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "_emit"):
                kws = {k.arg: k.value for k in node.keywords}
                correct = kws.get("correct")
                out.append((_name(node.args[0], env),
                            {"bench", "ms", *kws},
                            isinstance(correct, ast.Constant)
                            and correct.value is True))


@functools.lru_cache(maxsize=1)
def reference_records():
    """{ALL key: [(record name, keys, correct), ...]} of the reference."""
    tree = ast.parse(open(REF_CORPUS).read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    table = next(s.value for s in tree.body if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "ALL")
    out = {}
    for k, v in zip(table.keys, table.values):
        recs = []
        _records(funcs[v.id].body, {}, recs)
        out[k.value] = recs
    return out


def test_reference_has_forty_records():
    recs = reference_records()
    assert sum(len(v) for v in recs.values()) == 40
    assert list(recs) == list(corpus.ALL)


def test_records_and_gates_are_the_reference_ones():
    recs = reference_records()
    assert {k: tuple(n for n, _, _ in v) for k, v in recs.items()} \
        == corpus.RECORDS
    assert {n for v in recs.values() for n, _, c in v if c} \
        == set(corpus.GATED)


# -- the port's main at small sizes, nothing timed ----------------------------


def _one_call(fn, x0, iters=32, iters_small=4, reps=3, operand=None):
    fn(x0) if operand is None else fn(x0, operand)
    return 1e-3


SMALL_ARGS = {
    "stream": dict(n=1 << 12),
    "layout": dict(n=1 << 12),
    "transpose": dict(n=64, tile=16),
    "matmul": dict(sizes=(16, 32)),
    "conv": dict(n=32),
    "blur": dict(n=64),
    "sort": dict(n=5000, n_large=7000, n_radix=3000),
    "scan_hist": dict(n=1 << 12),
    "spmv": dict(grid=32),
    "sbell": dict(),
    "spmm_cg": dict(grid=32),
    "scale": dict(n_block_rows=500, window=1 << 14),
    "amg": dict(),
    "particles": dict(n=1 << 10, grid_blocks=(8, 8), capacity=64),
    "access": dict(n=1 << 12, n_random=1 << 10),
    "dtypes": dict(n=1 << 12),
}


@pytest.fixture
def small_corpus(monkeypatch):
    """corpus.ALL at small sizes on the CPU; cant_like / pwtk_like stand-ins
    of a few thousand rows (cant's above amg's coarse_max of 3000, so the
    hierarchy has a level); each timed step runs once."""
    small = {"cant": matrices.block_random(500, block=8, blocks_per_row=5,
                                           seed=1, half_band=4,
                                           far_fraction=0.05),
             "pwtk": matrices.block_random(400, block=8, blocks_per_row=4,
                                           seed=2, half_band=10,
                                           far_fraction=0.05)}
    monkeypatch.setattr(harness, "time_iterated", _one_call)
    monkeypatch.setattr(harness, "measure_hbm_bandwidth",
                        lambda device: 1e12)
    monkeypatch.setattr(harness, "measure_hbm_read_bandwidth",
                        lambda device: 1.5e12)
    monkeypatch.setattr(matrices, "load_or_synthesize", small.__getitem__)
    monkeypatch.setattr(matrices, "pwtk_like", lambda: small["pwtk"])
    for k, kw in SMALL_ARGS.items():
        monkeypatch.setitem(corpus.ALL, k, functools.partial(
            corpus.ALL[k], device="cpu", **kw))


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_main_prints_the_reference_records(small_corpus, capsys):
    corpus.main([])
    got = _printed(capsys)
    ref = [r for v in reference_records().values() for r in v]
    assert [d["bench"] for d in got] == [n for n, _, _ in ref]
    for d, (name, keys, correct) in zip(got, ref):
        assert "error" not in d, d
        want = (keys - DROPPED.get(name, set())) | ADDED.get(name, set())
        assert set(d) == want, name
        if correct:
            assert d["correct"] is True, name
    scale = next(d for d in got if d["bench"] == "spmv_sbell_100m_chunked")
    assert scale["launches"] == 0      # the CPU runs the plain version
    cg = next(d for d in got if d["bench"] == "cg_sbell_cant_32it")
    assert 1 <= cg["iters_run"] <= 32
    assert cg["iters_per_s"] == pytest.approx(cg["iters_run"] / 1e-3,
                                              rel=1e-3)


def _chained(fn, x0, iters=32, iters_small=4, reps=3, operand=None):
    """The harness's chain x -> fn(x), four steps long, and a fixed time."""
    x = x0
    for _ in range(4):
        x = fn(x) if operand is None else fn(x, operand)
    return 1e-3


def test_cg_steps_run_the_iterations_they_report(monkeypatch, capsys):
    """cant_like itself (not SPD): CG breaks down before 32 iterations and
    leaves a NaN iterate. Every chained step after the first must still run
    the iterations the record reports, and the rates must count them."""
    ran = {}

    def counted(fn, key):
        def wrapper(*a, **kw):
            x, it = fn(*a, **kw)
            ran.setdefault(key, []).append(it)
            return x, it
        return wrapper

    monkeypatch.setattr(corpus, "pane_cg", counted(corpus.pane_cg, "cant"))
    monkeypatch.setattr(corpus, "cg_fixed", counted(corpus.cg_fixed, "all"))
    monkeypatch.setattr(harness, "time_iterated", _chained)
    monkeypatch.setattr(harness, "measure_hbm_bandwidth",
                        lambda device: 1e12)
    corpus.bench_spmm_cg(grid=32, device="cpu")
    got = {d["bench"]: d for d in _printed(capsys)}
    cant = got["cg_sbell_cant_32it"]
    # corpus.time_iterated keeps the best of two readings: two chains
    assert ran["cant"] == [cant["iters_run"]] * 8
    assert 1 <= cant["iters_run"] < 32
    assert cant["iters_per_s"] == pytest.approx(cant["iters_run"] / 1e-3,
                                                rel=1e-3)
    assert cant["correct"] is True
    dia = got["cg_dia_poisson512s_32it"]
    # the gate's untimed solve and two chains of four, then the cant steps
    assert ran["all"][:9] == [32] * 9
    assert dia["iters_per_s"] == pytest.approx(32 / 1e-3, rel=1e-3)


def test_cg_record_is_an_error_where_steps_differ(capsys):
    corpus._emit_cg("x", 1e-3, [8, 8, 0, 0], 100)
    corpus._emit_cg("y", 1e-3, [0, 0], 100)
    corpus._emit_cg("w", 1e-3, [], 100, iters_run=True)
    corpus._emit_cg("z", 1e-3, [8, 8], 100, iters_run=True)
    assert _printed(capsys) == [
        {"bench": "x", "error": "timed steps ran [0, 8] iterations"},
        {"bench": "y", "error": "timed steps ran [0] iterations"},
        {"bench": "w", "error": "timed steps ran [] iterations"},
        {"bench": "z", "ms": 1.0, "iters_per_s": 8000.0,
         "gnnz_per_s": 0.001, "iters_run": 8, "correct": True}]


def test_main_reports_then_raises(small_corpus, monkeypatch, capsys):
    def broken(device="cpu"):
        raise ValueError("boom")

    monkeypatch.setitem(corpus.ALL, "conv", broken)
    with pytest.raises(RuntimeError, match="conv"):
        corpus.main(["conv", "stream"])
    got = _printed(capsys)
    assert got[0] == {"bench": "conv", "error": "boom"}
    assert got[1]["bench"] == "stream_mul_128MB"


def test_gate_failure_prints_an_error_record(small_corpus, monkeypatch,
                                             capsys):
    monkeypatch.setattr(corpus, "bf16_gate", lambda A, sb16, device: (
        False, None, None))
    corpus.ALL["sbell"]()
    got = _printed(capsys)
    assert [d["bench"] for d in got] == ["spmv_sbell_cant",
                                         "spmv_sbell_cant_bf16",
                                         "spmv_sbell_pwtk",
                                         "spmv_sbell_pwtk_bf16"]
    assert got[1] == {"bench": "spmv_sbell_cant_bf16",
                      "error": "incorrect result"}


def test_collapsed_reading_is_an_error_record(capsys):
    corpus._emit("x", float("nan"), a=1.0)
    corpus._emit("y", 0.0)
    assert _printed(capsys) == [{"bench": "x",
                                 "error": "no plausible reading"},
                                {"bench": "y",
                                 "error": "no plausible reading"}]


def test_time_iterated_keeps_the_best_of_two_plausible(monkeypatch):
    readings = iter([0.0, 3e-3, -1.0, 2e-3, 1e-3])
    monkeypatch.setattr(harness, "time_iterated",
                        lambda fn, x0, **kw: next(readings))
    assert corpus.time_iterated(None, None) == 2e-3
    readings = iter([0.0, 1e-8, -1.0, 5e-3])
    assert corpus.time_iterated(None, None) == 5e-3
    readings = iter([0.0] * 4)
    assert np.isnan(corpus.time_iterated(None, None))


def test_matmul_and_conv_run_without_tf32(monkeypatch):
    seen = []

    def record(fn, x0, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        fn(x0)
        return 1e-3

    monkeypatch.setattr(harness, "time_iterated", record)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    corpus.bench_conv(n=32, device="cpu")
    corpus.bench_matmul(sizes=(8, 16), device="cpu")
    assert seen and all(s == (False, False) for s in seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


# -- default sizes: the reference's literals ----------------------------------

DEFAULTS = [
    # (bench, keyword, default, reference corpus.py line of the literal)
    ("bench_stream", "n", 1 << 25, 56),
    ("bench_layout", "n", 1 << 25, 534),
    ("bench_transpose", "n", 8192, 65),
    ("bench_transpose", "tile", 256, 77),
    ("bench_matmul", "sizes", (1024, 8192), 95),
    ("bench_conv", "n", 1024, 108),
    ("bench_conv", "k", 16, 109),
    ("bench_blur", "n", 8192, 127),
    ("bench_blur", "radius", 8, 128),
    ("bench_sort", "n", 10_000_000, 141),
    ("bench_sort", "n_large", 100_000_000, 158),
    ("bench_sort", "n_radix", 1_000_000, 168),
    ("bench_scan_hist", "n", 1 << 22, 178),
    ("bench_spmv", "grid", 512, 200),
    ("bench_spmm_cg", "grid", 512, 298),
    ("bench_scale", "n_block_rows", 260_000, 400),
    ("bench_scale", "window", 1 << 22, 446),
    ("bench_particle_writes", "n", 1 << 20, 503),
    ("bench_particle_writes", "grid_blocks", (256, 256), 507),
    ("bench_particle_writes", "block_size", 16, 507),
    ("bench_particle_writes", "capacity", 65536, 507),
    ("bench_access", "n", 1 << 25, 576),
    ("bench_access", "n_random", 1 << 22, 581),
    ("bench_dtypes", "n", 1 << 27, 597),
]


@pytest.mark.parametrize("bench,kw,default,line", DEFAULTS,
                         ids=[f"{b}-{k}" for b, k, _, _ in DEFAULTS])
def test_default_sizes_are_the_reference_literals(bench, kw, default, line):
    params = inspect.signature(getattr(corpus, bench)).parameters
    assert params[kw].default == default
    src = open(REF_CORPUS).read().splitlines()[line - 1]
    literal = {1 << 25: "1 << 25", 1 << 22: "1 << 22", 1 << 27: "1 << 27",
               1 << 20: "1 << 20", (1024, 8192): "(1024, 8192)",
               (256, 256): "(256, 256)", 10_000_000: "10_000_000",
               100_000_000: "100_000_000", 1_000_000: "1_000_000",
               260_000: "260_000"}.get(default, str(default))
    assert literal in src, (line, src)


def test_every_bench_defaults_to_the_card():
    for fn in corpus.ALL.values():
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(dryrun.entry).parameters[
        "device"].default == "cuda"


# -- the corpus's compositions against the reference --------------------------


def test_morton_transpose_matches_reference():
    nt, T = 4, 8
    n = nt * T
    x = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    got = corpus.morton_transpose_fn(n, T, device="cpu")(torch.from_numpy(x))

    # the reference's morton_transpose (libhpc_tpu/bench/corpus.py:79-87)
    ty, tx = ref_morton2d_decode(jnp.arange(nt * nt, dtype=jnp.uint32))
    v = jnp.asarray(x)
    tiles = v.reshape(nt, T, nt, T).transpose(0, 2, 1, 3)
    gt = jnp.swapaxes(tiles[ty, tx], 1, 2)
    out = jnp.zeros_like(tiles).at[tx, ty].set(gt)
    want = np.asarray(out.transpose(0, 2, 1, 3).reshape(n, n) + 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x.T)


def test_shifted_poisson_dia_cg_is_float32_and_matches_reference():
    A = matrices.poisson2d(16)
    A_sh, D = corpus.shifted_dia(A, device="cpu")
    assert A_sh.dtype == np.float64
    assert D.data.dtype == torch.float32
    b = np.ones(A.shape[0], np.float32)
    x, it = corpus.cg_fixed(lambda u: spmv.dia_spmv(D, u),
                            torch.from_numpy(b), 32)
    assert x.dtype == torch.float32 and it == 32

    A_ref = (A + sps.eye(A.shape[0]) * 0.5).tocsr()
    D_ref = RefDIA.from_scipy(A_ref)
    assert D_ref.data.dtype == jnp.float32
    x_ref, it_ref, _ = ref_solver.cg(lambda u: ref_spmv.dia_spmv(D_ref, u),
                                     jnp.asarray(b), tol=0.0, max_iter=32)
    assert int(it_ref) == it
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-5,
                               atol=1e-6)
    r = b - A_sh @ x.numpy()
    assert np.linalg.norm(r) < 1e-3 * np.linalg.norm(b)


def test_pane_cg_matches_reference():
    A = matrices.block_random(120, block=8, blocks_per_row=5, seed=3,
                              half_band=4, far_fraction=0.05)
    sb = SBELL.from_scipy(A, device="cpu")
    sb_ref = RefSBELL.from_scipy(A)
    ones = np.ones(sb.n_panes * 1024, np.float32)
    b3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(ones))
    b3_ref = ref_pallas.x_to_panes(sb_ref, jnp.asarray(ones))
    np.testing.assert_array_equal(b3.numpy(), np.asarray(b3_ref))
    # the matrix is not SPD: past ~12 iterations the iterates grow to
    # 1e17 and where CG breaks down (rs NaN) depends on rounding, so the
    # runs are compared at 4 and 8 iterations
    for n_it in (4, 8):
        x3, it = corpus.pane_cg(sb, b3, n_it)
        x3_ref, it_ref, _ = ref_solver.cg(
            lambda u: ref_pallas.sbell_spmv_panes(sb_ref, u), b3_ref,
            tol=0.0, max_iter=n_it)
        assert it == int(it_ref) == n_it
        want = np.asarray(x3_ref)
        np.testing.assert_allclose(x3.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())


def test_bf16_gate_matches_reference():
    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=9,
                              half_band=5, far_fraction=0.05)
    sb16 = SBELL.from_scipy(A, device="cpu").astype_values(torch.bfloat16)
    ok, y16, Aq = corpus.bf16_gate(A, sb16, device="cpu")
    assert ok

    # the reference's gate (libhpc_tpu/bench/corpus.py:246-256)
    sb16_ref = RefSBELL.from_scipy(A).astype_values(jnp.bfloat16)
    xf = np.linspace(-1, 1, A.shape[1], dtype=np.float32)
    Aq_ref = np.asarray(jnp.asarray(A.data).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(Aq.data, Aq_ref)
    y_ref = np.asarray(ref_pallas.sbell_spmv(sb16_ref, jnp.asarray(xf)))
    np.testing.assert_allclose(y16, y_ref, rtol=1e-5, atol=1e-5)
    assert np.allclose(y_ref, Aq @ xf, rtol=2e-3, atol=2e-3)
    # the gate tells the quantized operator from the float32 one
    assert not np.allclose(y16, A @ xf, rtol=1e-5, atol=1e-5)


def test_scale_sbell_case_matches_reference():
    A = matrices.block_random_fast(2_000, blocks_per_row=8, half_band=6,
                                   far_fraction=0.01, seed=3)
    from libhpc_tpu.bench import matrices as ref_matrices

    A_ref = ref_matrices.block_random_fast(2_000, blocks_per_row=8,
                                           half_band=6, far_fraction=0.01,
                                           seed=3)
    assert (A != A_ref).nnz == 0
    sb = SBELL.from_scipy(A, device="cpu")
    assert isinstance(sb.far, FarPane)
    sb_ref = RefSBELL.from_scipy(A_ref)
    m, n = A.shape
    xn = np.linspace(-1, 1, n).astype(np.float32)
    y = spmv_sbell.sbell_spmv(sb, torch.from_numpy(xn)).numpy()
    y_ref = np.asarray(ref_pallas.sbell_spmv(sb_ref, jnp.asarray(xn)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-4)
    assert np.allclose(y, A @ xn, rtol=2e-3, atol=2e-3)
    # the timed form: pane layout, the matrix as the chain's operand
    x3 = spmv_sbell.x_to_panes(sb, torch.nn.functional.pad(
        torch.from_numpy(xn), (0, sb.n_panes * 1024 - n)))
    y3 = spmv_sbell.panes_to_x(sb, spmv_sbell.sbell_spmv_panes(sb, x3))[:m]
    np.testing.assert_allclose(y3.numpy(), y, rtol=1e-6, atol=1e-6)


def test_entry_cg_step_matches_reference():
    step, (csr, x, b) = dryrun.entry(device="cpu")
    assert csr.device.type == "cpu" and x.dtype == torch.float32
    got = step(csr, x, b)
    ref_step, ref_args = ref_entry.entry()
    want = np.asarray(ref_step(*ref_args))
    assert got.shape == want.shape == (4096,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
