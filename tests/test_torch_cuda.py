"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine that has the
card but not the reference package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version see the same inputs; they sum in different orders
(and the kernel contracts multiply-adds), so results agree to rtol 1e-5 with
an absolute floor of 1e-5 * max|y|.
"""

import faulthandler

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.ops import (_cuda_utils, cg_vectors, far_sbell, sellp,
                                  solver, spmv_dia, spmv_sbell, spmv_sell)
from libhpc_tpu_torch.sparse import DIA, auto
from libhpc_tpu_torch.sparse.sbell import B, W_PANES, SBELL, FarBlocks, FarPane

from libhpc_tpu_torch.ops import sort_merge as sm
from libhpc_tpu_torch.ops import sort_merge_kv as kv

from _torch_port import CHUNK_KEY_KINDS, chunk_keys
from _torch_port import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _spread(n_panes):
    k = np.arange(128, dtype=np.int64)
    bcols = (k % n_panes) * 128 + (k * 7) % 128
    return sps.coo_matrix(
        (np.linspace(1, 2, 128, dtype=np.float32), (k * 8, bcols * 8)),
        shape=(1024, n_panes * 1024)).tocsr()


def _multi_pane_spread():
    n = 6000
    rows = np.repeat(np.arange(n), 3)
    cols = np.concatenate([np.arange(n), (np.arange(n) * 977) % n,
                           (np.arange(n) * 31 + 17) % n])
    A = sps.coo_matrix((np.ones(cols.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


MATRICES = {
    "block_far": lambda: matrices.block_random(
        260, block=8, blocks_per_row=6, seed=21, half_band=5,
        far_fraction=0.05),
    "far_split": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.3),
    "wide_spread": lambda: _spread(32),
    "multi_pane_spread": _multi_pane_spread,
    "single_stripe": lambda: sps.random(
        8, 8, density=0.5, format="csr", dtype=np.float32, random_state=42),
    "poisson2d_64": lambda: matrices.poisson2d(64),
    "rect": lambda: sps.random(500, 1300, density=0.01, format="csr",
                               dtype=np.float32, random_state=7),
}


def _close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale + 1e-30)


def _x3(sb, dev, seed=0):
    x = np.random.default_rng(seed).standard_normal(sb.n_panes * 1024)
    return spmv_sbell.x_to_panes(
        sb, torch.from_numpy(x.astype(np.float32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_near_kernel_matches_plain(cuda_device, name, dtype):
    sb = SBELL.from_scipy(MATRICES[name]())
    if dtype != torch.float32:
        sb = sb.astype_values(dtype)
    sb = sb.to(cuda_device)
    x3 = _x3(sb, cuda_device)
    n0 = spmv_sbell.NEAR_LAUNCHES
    got = spmv_sbell.near_out_panes(sb, x3)
    assert spmv_sbell.NEAR_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = spmv_sbell.near_out_panes_torch(sb, x3)
    assert got.shape == want.shape == ((sb.n_stripes + W_PANES - 1) * B,
                                       128)
    assert torch.all(got[sb.n_stripes * B:] == 0)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["block_far", "far_split", "wide_spread"])
def test_far_kernel_matches_plain(cuda_device, name, dtype):
    sb = SBELL.from_scipy(MATRICES[name]())
    if dtype != torch.float32:
        sb = sb.astype_values(dtype)
    sb = sb.to(cuda_device)
    assert isinstance(sb.far, FarPane)
    x3 = _x3(sb, cuda_device, seed=1)
    guarded = (sb.n_stripes + W_PANES - 1) * B
    n0 = far_sbell.FAR_LAUNCHES
    got = far_sbell.far_pane_out_panes(sb.far, x3, guarded)
    assert far_sbell.FAR_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    _close(got, far_sbell.far_pane_out_panes_torch(sb.far, x3, guarded))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sbell_spmv_on_card(cuda_device, name):
    A = MATRICES[name]()
    sb = SBELL.from_scipy(A)
    x = np.linspace(-1, 1, A.shape[1]).astype(np.float32)
    y = spmv_sbell.sbell_spmv(sb.to(cuda_device),
                              torch.from_numpy(x).to(cuda_device))
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(), A @ x, rtol=1e-4, atol=1e-5)
    if name == "multi_pane_spread":
        assert isinstance(sb.far, FarBlocks)


def test_wrappers_raise_on_bad_input(cuda_device):
    sb = SBELL.from_scipy(MATRICES["block_far"]()).to(cuda_device)
    x3 = _x3(sb, cuda_device)
    guarded = (sb.n_stripes + W_PANES - 1) * B
    with pytest.raises(TypeError):
        spmv_sbell.near_out_panes(sb, x3.double())
    with pytest.raises(ValueError):
        spmv_sbell.near_out_panes(sb, x3[:-1])
    with pytest.raises(ValueError):
        spmv_sbell.near_out_panes(sb, x3.transpose(1, 2).contiguous()
                                  .transpose(1, 2))
    with pytest.raises(ValueError):
        spmv_sbell.near_out_panes(sb, x3.cpu())
    with pytest.raises(TypeError):
        far_sbell.far_pane_out_panes(sb.far, x3.half(), guarded)
    with pytest.raises(ValueError):
        far_sbell.far_pane_out_panes(sb.far, x3.cpu(), guarded)


def _x3_plain(sb, x3):
    guarded = (sb.n_stripes + W_PANES - 1) * B
    out = spmv_sbell.near_out_panes_torch(sb, x3)
    if sb.far is not None:
        out = out + far_sbell.far_pane_out_panes_torch(sb.far, x3, guarded)
    return out.reshape(-1, B, 128)


def _counts():
    return (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES,
            far_sbell.FAR_LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["block_far", "far_split", "wide_spread"])
def test_fused_spmv_matches_plain(cuda_device, name, dtype):
    """One fused launch a sbell_spmv_panes call, no near-only or far-only
    launch, against the plain near + far at TOL_PLAIN."""
    sb = SBELL.from_scipy(MATRICES[name]())
    if dtype != torch.float32:
        sb = sb.astype_values(dtype)
    sb = sb.to(cuda_device)
    assert isinstance(sb.far, FarPane)
    x3 = _x3(sb, cuda_device, seed=2)
    s0, n0, f0 = _counts()
    got = spmv_sbell.sbell_spmv_panes(sb, x3)
    assert _counts() == (s0 + 1, n0, f0)
    torch.cuda.synchronize()
    assert torch.all(got[sb.n_stripes:] == 0)
    _close(got, _x3_plain(sb, x3))


def _stripe_depths():
    """Five stripes: stripe 0 has K_CAP tiles (its block-rows hold 32 or
    33 blocks in one pane: 32 slices kept, the 64 blocks of slice 33 go
    far), stripe 1 none, stripe 2 one (a block diagonal), stripe 3 three,
    stripe 4 none."""
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for br in range(128):                       # stripe 0
        k = 33 if br < 64 else 32
        rows += [br] * k
        cols += list(range(k))
    for br in range(256, 384):                  # stripe 2
        rows.append(br)
        cols.append(br)
    for br in range(384, 512):                  # stripe 3
        rows += [br] * 3
        cols += [br - 1, br, br + 1]
    rows, cols = np.array(rows), np.array(cols)
    n = 5 * 1024
    r = (rows[:, None] * 8 + np.arange(8)).repeat(8, axis=1).ravel()
    c = np.tile(cols[:, None] * 8 + np.arange(8), (1, 8)).ravel()
    v = rng.standard_normal(r.size).astype(np.float32)
    return sps.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["stripe_depths", "far_split", "block_far"])
def test_spmv_kernel_every_mode(cuda_device, hang_guard, name, dtype):
    """Each mode against its plain version, into memory that held NaN.
    stripe_depths: stripes of K_CAP, 0, 1 and 3 tiles (more tiles than the
    ring has stages, fewer, and none); far_split and block_far: far entries
    in stripes with few tiles."""
    from libhpc_tpu_torch.sparse.sbell import K_CAP

    A = _stripe_depths() if name == "stripe_depths" else MATRICES[name]()
    sb = SBELL.from_scipy(A)
    if dtype != torch.float32:
        sb = sb.astype_values(dtype)
    sb = sb.to(cuda_device)
    depth = np.diff(sb.tile_ptr.cpu().numpy())
    if name == "stripe_depths":
        assert list(depth) == [K_CAP, 0, 1, 3, 0]
    assert isinstance(sb.far, FarPane)
    x3 = _x3(sb, cuda_device, seed=3)
    S = sb.n_stripes + W_PANES - 1
    near = spmv_sbell.near_out_panes_torch(sb, x3)
    both = _x3_plain(sb, x3).reshape(-1, 128)
    for mode, want in ((spmv_sbell.MODE_NEAR, near),
                       (spmv_sbell.MODE_BOTH, both)):
        out = torch.full_like(want, float("nan"))
        spmv_sbell.launch(mode, sb, sb.far if mode == 3 else None, x3, out, S)
        torch.cuda.synchronize()
        _close(out, want)
    far = far_sbell.far_pane_out_panes_torch(sb.far, x3, sb.far.n_grouped * B)
    out = torch.full_like(far, float("nan"))
    spmv_sbell.launch(spmv_sbell.MODE_FAR, None, sb.far, x3, out,
                      sb.far.n_grouped)
    _close(out, far)


@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices")
def test_spmv_launches_on_a_second_device(cuda_device):
    """The kernel's shared-memory opt-in is made on each device: f32 rings
    take more than 48 KB, so a launch on a device that missed it fails.
    Each mode runs on device 0, then on device 1."""
    A = MATRICES["block_far"]()
    for dev in ("cuda:0", "cuda:1"):
        sb = SBELL.from_scipy(A).to(dev)
        x3 = _x3(sb, torch.device(dev), seed=6)
        rows = (sb.n_stripes + W_PANES - 1) * B
        with torch.cuda.device(dev):
            got = spmv_sbell.sbell_spmv_panes(sb, x3)
            near = spmv_sbell.near_out_panes(sb, x3)
            far = far_sbell.far_pane_out_panes(sb.far, x3, rows)
            torch.cuda.synchronize()
        _close(got, _x3_plain(sb, x3))
        _close(near, spmv_sbell.near_out_panes_torch(sb, x3))
        _close(far, far_sbell.far_pane_out_panes_torch(sb.far, x3, rows))


def test_spmv_guard_stripes_zero_over_nan(cuda_device):
    """The kernel writes every output itself: memory that held NaN comes
    back with exact zeros in the guard stripes and empty stripes."""
    sb = SBELL.from_scipy(_stripe_depths()).to(cuda_device)
    x3 = _x3(sb, cuda_device, seed=4)
    rows = (sb.n_stripes + W_PANES - 1) * B
    for _ in range(3):
        junk = torch.full((rows, 128), float("nan"), device=cuda_device)
        del junk
        for got in (spmv_sbell.sbell_spmv_panes(sb, x3).reshape(-1, 128),
                    spmv_sbell.near_out_panes(sb, x3)):
            torch.cuda.synchronize()
            assert torch.all(torch.isfinite(got))
            assert torch.all(got[sb.n_stripes * B:] == 0)
            assert torch.all(got[B:2 * B] == 0)      # stripe 1: no tiles
    far = far_sbell.far_pane_out_panes(sb.far, x3, rows)
    assert torch.all(far[sb.n_stripes * B:] == 0)


def test_spmv_far_blocks_take_near_launch(cuda_device):
    sb = SBELL.from_scipy(MATRICES["far_split"](), group_far=False)
    sb = sb.to(cuda_device)
    assert isinstance(sb.far, FarBlocks)
    x3 = _x3(sb, cuda_device, seed=5)
    s0, n0, f0 = _counts()
    got = spmv_sbell.sbell_spmv_panes(sb, x3)
    assert _counts() == (s0, n0 + 1, f0)
    A = MATRICES["far_split"]()
    x = spmv_sbell.panes_to_x(sb, x3)[:A.shape[1]].cpu().numpy()
    y = spmv_sbell.panes_to_x(sb, got)[:A.shape[0]].cpu().numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-4)


def test_spmv_raises_on_misaligned_or_strided_input(cuda_device):
    import dataclasses

    sb = SBELL.from_scipy(MATRICES["block_far"]()).to(cuda_device)
    x3 = _x3(sb, cuda_device)
    guarded = (sb.n_stripes + W_PANES - 1) * B

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    x3m = shifted(x3)
    for call in (lambda: spmv_sbell.sbell_spmv_panes(sb, x3m),
                 lambda: spmv_sbell.near_out_panes(sb, x3m),
                 lambda: far_sbell.far_pane_out_panes(sb.far, x3m, guarded)):
        with pytest.raises(ValueError, match="aligned"):
            call()
    for field in ("vflat", "meta"):
        bad = dataclasses.replace(sb, **{field: shifted(getattr(sb, field))})
        with pytest.raises(ValueError, match="aligned"):
            spmv_sbell.sbell_spmv_panes(bad, x3)
        strided = getattr(sb, field).t().contiguous().t()
        bad = dataclasses.replace(sb, **{field: strided})
        with pytest.raises(ValueError, match="contiguous"):
            spmv_sbell.sbell_spmv_panes(bad, x3)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_sbell.sbell_spmv_panes(sb, x3.transpose(1, 2).contiguous()
                                    .transpose(1, 2))
    mixed = dataclasses.replace(
        sb, far=dataclasses.replace(sb.far, bt=sb.far.bt.to(torch.bfloat16)))
    with pytest.raises(TypeError):
        spmv_sbell.sbell_spmv_panes(mixed, x3)
    with pytest.raises(RuntimeError):      # an unknown mode
        spmv_sbell.launch(0, sb, None, x3,
                          torch.empty(guarded, 128, device=cuda_device),
                          sb.n_stripes + W_PANES - 1)


def test_library_is_keyed_by_sources(cuda_device):
    path = _cuda_utils.build_library()
    assert path.exists() and path.parent == _cuda_utils.BUILD_DIR
    assert path == _cuda_utils.library_path()


def test_cg_panes_on_card_matches_cpu(cuda_device):
    Au = matrices.block_random(260, block=8, blocks_per_row=5, seed=13,
                               half_band=5, far_fraction=0.04)
    As = Au + Au.T
    rowsum = np.asarray(np.abs(As).sum(axis=1)).ravel()
    A = (As + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)
    n = A.shape[0]
    sb = SBELL.from_scipy(A, device="cpu")
    b = np.zeros(sb.n_panes * 1024, np.float32)
    b[:n] = 1.0
    out = {}
    for dev in ("cpu", cuda_device):
        s = sb.to(dev)
        b3 = spmv_sbell.x_to_panes(s, torch.from_numpy(b).to(dev))
        out[str(dev)] = solver.cg(
            lambda u: spmv_sbell.sbell_spmv_panes(s, u), b3, tol=1e-5)
    (xc, itc, _), (xg, itg, _) = out["cpu"], out[str(cuda_device)]
    assert abs(itc - itg) <= 1
    x = spmv_sbell.panes_to_x(sb, xg.cpu()).numpy()[:n]
    r = b[:n].astype(np.float64) - A @ x.astype(np.float64)
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b[:n])
    np.testing.assert_allclose(x, spmv_sbell.panes_to_x(sb, xc).numpy()[:n],
                               rtol=1e-3, atol=1e-6)


def _banded(n, offs, dtype=np.float32):
    return sps.diags([np.full(n - abs(o), 1.0 + o, dtype) for o in offs],
                     offs, shape=(n, n), format="csr", dtype=dtype)


def _irregular_banded(n=4000):
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), 4)
    cols = np.clip(rows + rng.integers(-120, 121, rows.size), 0, n - 1)
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


DIA_MATRICES = {
    "banded9000": lambda: _banded(9000, (-70, -1, 0, 1, 65)),
    "poisson96": lambda: matrices.poisson2d(96),
    "multi_tile_poisson128": lambda: matrices.poisson2d(128),
    "wide_rect": lambda: sps.diags([np.ones(1000)], [0], shape=(1000, 200000),
                                   format="csr", dtype=np.float32),
    "many_diagonals": lambda: _banded(5000, tuple(range(-47, 49))),
}


@pytest.mark.parametrize("name", sorted(DIA_MATRICES))
def test_dia_kernels_match_plain(cuda_device, name):
    """K4 and K5 against their plain versions on the same x_ext."""
    A = DIA_MATRICES[name]()
    dp = DIA.from_scipy(A).to_pallas(T=1 << 13).to(cuda_device)
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    x_ext = spmv_dia.extend_x(dp, torch.from_numpy(x.astype(np.float32))
                              .to(cuda_device))
    n0, p0 = spmv_dia.DIA_LAUNCHES, spmv_dia.PROBE_LAUNCHES
    got = spmv_dia.dia_out(dp, x_ext)
    probe = spmv_dia.dia_probe_out(dp, x_ext)
    assert (spmv_dia.DIA_LAUNCHES, spmv_dia.PROBE_LAUNCHES) == (n0 + 1, p0 + 1)
    torch.cuda.synchronize()
    _close(got, spmv_dia.dia_out_torch(dp, x_ext))
    _close(probe, spmv_dia.dia_probe_out_torch(dp, x_ext))
    y = spmv_dia.dia_spmv_pallas(dp, torch.from_numpy(x.astype(np.float32))
                                 .to(cuda_device))
    np.testing.assert_allclose(y.cpu().numpy(), A @ x.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_cg_ranges_hold_k4_alone_and_change_nothing(cuda_device, tmp_path):
    """A CG through K4 traced by torch.profiler: K4 is the one device
    operation launched inside each libhpc.spmv.launch range, once a
    matvec, and the traced solve equals the untraced one bit for bit."""
    import json

    from torch.profiler import ProfilerActivity, profile

    A = matrices.poisson2d(256)
    dp = DIA.from_scipy(A).to_pallas(T=1 << 13).to(cuda_device)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.shape[0]).astype(np.float32)).to(cuda_device)
    calls = []

    def mv(v):
        calls.append(1)
        return spmv_dia.dia_spmv_pallas(dp, v)

    n0 = spmv_dia.DIA_LAUNCHES
    plain = solver.cg(mv, b, tol=0.0, max_iter=8)
    assert spmv_dia.DIA_LAUNCHES - n0 == len(calls) == 9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = solver.cg(mv, b, tol=0.0, max_iter=8)
        torch.cuda.synchronize()
    assert plain[1] == traced[1] == 8
    assert torch.equal(plain[0], traced[0])
    assert torch.equal(plain[2], traced[2])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    # the host's ranges (the profiler also mirrors each range onto the
    # device's timeline as a gpu_user_annotation)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in xs
             if e.get("name") == "libhpc.spmv.launch"
             and e.get("cat") == "user_annotation"]
    launched = {(e.get("args") or {}).get("correlation"): e["ts"]
                for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    inside = [e["name"] for e in xs if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")
              and any(s <= launched.get(e["args"].get("correlation"), -1)
                      <= t for s, t in spans)]
    assert len(spans) == 9
    assert len(inside) == 9 and all("dia_kernel" in n for n in inside), inside


CG_SIZES = (1, 1000, 4099, 1 << 20, 1 << 24)


def _cg_operands(n, dtype, dev, shape=None, offset=0):
    """x, r, p, Ap of n entries each, `offset` elements into their buffers
    and in `shape`; p and Ap positive, so that p . Ap is well conditioned."""
    g = torch.Generator().manual_seed(n + offset)

    def vec(lo):
        v = (torch.rand(n + offset, generator=g, dtype=torch.float64) + lo)
        v = v.to(dtype).to(dev)[offset:]
        return v.reshape(shape) if shape else v

    return vec(-0.5), vec(-0.5), vec(0.5), vec(0.5)


def _check_cg_steps(x, r, p, Ap):
    """Each kernel of csrc/cg_vectors.cu against its plain version, both on
    the card; the plain side takes the kernel's scalars before each step,
    so that every step is compared on the same inputs."""
    rtol = 1e-5 if x.dtype == torch.float32 else 1e-10
    rs = cg_vectors.sdot(r, r)
    ws, wp = cg_vectors.Workspace(r, rs), cg_vectors.Workspace(r, rs)
    xp, rp, pp = x.clone(), r.clone(), p.clone()
    n0 = cg_vectors.CG_VECTOR_LAUNCHES

    def close(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * scale + 1e-30)

    cg_vectors.dot_pAp(p, Ap, ws)
    cg_vectors.dot_pAp_torch(pp, Ap, wp)
    close(ws.state[:2], wp.state[:2])
    wp.state[:2] = ws.state[:2]
    cg_vectors.update_xr(x, r, p, Ap, ws)
    cg_vectors.update_xr_torch(xp, rp, pp, Ap, wp)
    close(x, xp)
    close(r, rp)
    close(ws.state[:3], wp.state[:3])
    wp.state[:3] = ws.state[:3]
    cg_vectors.update_p(p, r, ws)
    cg_vectors.update_p_torch(pp, r, wp)
    close(p, pp)
    assert cg_vectors.CG_VECTOR_LAUNCHES == n0 + 3
    assert int(ws.ticket) == 0, "a reduction left its ticket set"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", CG_SIZES)
def test_cg_vector_kernels_match_plain(cuda_device, n, dtype):
    _check_cg_steps(*_cg_operands(n, dtype, cuda_device))


@pytest.mark.parametrize("layout", ["offset_by_one", "panes"])
def test_cg_vector_kernels_take_any_contiguous_layout(cuda_device, layout):
    """An unaligned view (the kernels' element path) and SBELL's
    (panes, 8, 128) layout."""
    if layout == "offset_by_one":
        ops = _cg_operands(4099, torch.float32, cuda_device, offset=1)
        assert all(v.data_ptr() % 16 for v in ops)
    else:
        ops = _cg_operands(37 * 1024, torch.float32, cuda_device,
                           shape=(37, 8, 128))
    _check_cg_steps(*ops)


def _poisson_dia_cg(dev):
    A = matrices.poisson2d(256)
    dp = DIA.from_scipy(A).to_pallas(T=1 << 13).to(dev)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.shape[0]).astype(np.float32)).to(dev)
    return (lambda v: spmv_dia.dia_spmv_pallas(dp, v)), b


def test_cg_on_card_is_three_launches_an_iteration_and_reproducible(
        cuda_device):
    """50 iterations on a Poisson DIA: three vector launches an iteration,
    the same bits from two solves, the plain loop's x to rtol 1e-4, and
    the caller's b and x0 left as they were."""
    mv, b = _poisson_dia_cg(cuda_device)
    n0 = cg_vectors.CG_VECTOR_LAUNCHES
    x1, it1, res1 = solver.cg(mv, b, tol=0.0, max_iter=50)
    assert it1 == 50 and cg_vectors.CG_VECTOR_LAUNCHES - n0 == 150
    x2, it2, res2 = solver.cg(mv, b, tol=0.0, max_iter=50)
    assert it2 == 50 and torch.equal(x1, x2) and torch.equal(res1, res2)
    xp, itp, resp = solver._cg(mv, b, None, 0.0, 50, solver._sdot)
    assert itp == 50
    torch.testing.assert_close(x1, xp, rtol=1e-4,
                               atol=1e-5 * float(xp.abs().max()))
    torch.testing.assert_close(res1, resp, rtol=1e-3, atol=0.0)
    x0 = 0.5 * x1
    b_before, x0_before = b.clone(), x0.clone()
    x3, it3, _ = solver.cg(mv, b, x0, tol=0.0, max_iter=5)
    assert it3 == 5 and x3.data_ptr() != x0.data_ptr()
    assert torch.equal(b, b_before) and torch.equal(x0, x0_before)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_cg_vector_kernels_refuse_half_precision(cuda_device, dtype):
    b = torch.ones(1000, device=cuda_device, dtype=dtype)
    n0 = cg_vectors.CG_VECTOR_LAUNCHES
    with pytest.raises(TypeError, match="dtype"):
        solver.cg(lambda v: 2 * v, b, tol=0.0, max_iter=3)
    assert cg_vectors.CG_VECTOR_LAUNCHES == n0


SELL_MATRICES = {
    "banded1000": lambda: _banded(1000, (-2, -1, 0, 1, 3)),
    "poisson64": lambda: matrices.poisson2d(64),
    "irregular_banded": _irregular_banded,
    "split_banded20000": lambda: _banded(20000, (-2, -1, 0, 1, 3)),
    "rect": lambda: sps.random(500, 1300, density=0.01, format="csr",
                               dtype=np.float32, random_state=7),
}


@pytest.mark.parametrize("name", sorted(SELL_MATRICES))
def test_sell_kernel_matches_plain(cuda_device, name):
    """K6 on every part (a SELLSplit runs two launches) against its plain
    version, and the whole sell_spmv against scipy."""
    A = SELL_MATRICES[name]()
    sp = spmv_sell.sell_from_scipy(A).to(cuda_device)
    parts = ((sp.near, sp.wide) if isinstance(sp, spmv_sell.SELLSplit)
             else (sp,))
    if name == "split_banded20000":
        assert len(parts) == 2
    x = np.random.default_rng(3).standard_normal(A.shape[1]) \
        .astype(np.float32)
    x3 = spmv_sell.x_panes(torch.from_numpy(x).to(cuda_device), sp.n_panes,
                           sp.W - 1)
    for part in parts:
        n0 = spmv_sell.SELL_LAUNCHES
        got = spmv_sell.sell_out_panes(part, x3)
        assert spmv_sell.SELL_LAUNCHES == n0 + 1
        torch.cuda.synchronize()
        assert torch.all(got[part.n_stripes * B:] == 0)
        _close(got, spmv_sell.sell_out_panes_torch(part, x3))
    n0 = spmv_sell.SELL_LAUNCHES
    y = spmv_sell.sell_spmv(sp, torch.from_numpy(x).to(cuda_device))
    assert spmv_sell.SELL_LAUNCHES == n0 + len(parts)
    np.testing.assert_allclose(y.cpu().numpy(), A @ x, rtol=1e-4, atol=1e-5)


def _no_window_restriction():
    n = 8192
    rng = np.random.default_rng(8)
    rows = np.arange(n).repeat(2)
    cols = np.concatenate([np.arange(n)[:, None],
                           rng.integers(0, n, (n, 1))], axis=1).ravel()
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


SELLP_MATRICES = {
    "poisson96": lambda: matrices.poisson2d(96),
    "no_window_restriction": _no_window_restriction,
    "rect": lambda: sps.random(1111, 2222, density=0.004, random_state=6,
                               format="csr", dtype=np.float32),
    "fem_blocks": lambda: matrices.block_random(
        300, block=8, blocks_per_row=5, seed=3, half_band=4,
        far_fraction=0.02),
}


@pytest.mark.parametrize("name", sorted(SELLP_MATRICES))
def test_sellp_kernel_matches_plain(cuda_device, name):
    A = sps.csr_matrix(SELLP_MATRICES[name](), dtype=np.float32)
    sp = sellp.sellp_from_scipy(A).to(cuda_device)
    x = np.random.default_rng(4).standard_normal(A.shape[1]) \
        .astype(np.float32)
    x3 = spmv_sell.x_panes(torch.from_numpy(x).to(cuda_device), sp.n_panes)
    n0 = sellp.SELLP_LAUNCHES
    got = sellp.sellp_out_panes(sp, x3)
    assert sellp.SELLP_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    _close(got, sellp.sellp_out_panes_torch(sp, x3))
    y = sellp.sellp_spmv(sp, torch.from_numpy(x).to(cuda_device))
    np.testing.assert_allclose(y.cpu().numpy(), A @ x, rtol=1e-4, atol=1e-4)


AUTO_MATRICES = {
    "poisson64": ("DIA", lambda: matrices.poisson2d(64), None),
    "poisson96_pallas": ("DiaPallas", lambda: matrices.poisson2d(96),
                         spmv_dia),
    "irregular_banded": ("SELL", _irregular_banded, spmv_sell),
    "spread_diagonals": ("SELLP", lambda: _banded(
        4096, tuple(9 * k - 450 for k in range(101))), sellp),
    "fem": ("SBELL", lambda: matrices.block_random(
        200, block=8, blocks_per_row=6, seed=2, half_band=5,
        far_fraction=0.05), spmv_sbell),
}


@pytest.mark.parametrize("name", sorted(AUTO_MATRICES))
def test_auto_format_routes_on_card(cuda_device, monkeypatch, name):
    """Each auto_format route moved to the card: the matvec matches scipy
    at 2e-3 and a kernel route launches its kernel."""
    kind, make, mod = AUTO_MATRICES[name]
    if kind == "DiaPallas":
        monkeypatch.setattr(auto, "_DIA_VMEM_BYTES", 1024)
    A = make()
    c, mv = auto.auto_format(A)
    assert type(c).__name__ == kind
    c = c.to(cuda_device)
    counters = {"DiaPallas": "DIA_LAUNCHES", "SELL": "SELL_LAUNCHES",
                "SELLP": "SELLP_LAUNCHES", "SBELL": "SPMV_LAUNCHES"}
    n0 = getattr(mod, counters[kind]) if mod else 0
    x = np.linspace(-1, 1, A.shape[1]).astype(np.float32)
    y = mv(c, torch.from_numpy(x).to(cuda_device))
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(), A @ x, rtol=2e-3, atol=2e-3)
    if mod:
        assert getattr(mod, counters[kind]) > n0


def test_new_wrappers_raise_on_bad_input(cuda_device):
    A = matrices.poisson2d(64)
    dp = DIA.from_scipy(A).to_pallas(T=1 << 13).to(cuda_device)
    x_ext = spmv_dia.extend_x(dp, torch.zeros(A.shape[1], device=cuda_device))
    with pytest.raises(ValueError):
        spmv_dia.dia_out(dp, x_ext[:-1])
    with pytest.raises(TypeError):
        spmv_dia.dia_probe_out(dp, x_ext.double())
    with pytest.raises(ValueError):
        spmv_dia.dia_out(dp, x_ext.cpu())
    sp = spmv_sell.sell_from_scipy(A).to(cuda_device)
    x3 = spmv_sell.x_panes(torch.zeros(A.shape[1], device=cuda_device),
                           sp.n_panes, sp.W - 1)
    with pytest.raises(ValueError):
        spmv_sell.sell_out_panes(sp, x3[:sp.n_panes - 1])
    with pytest.raises(TypeError):
        spmv_sell.sell_out_panes(sp, x3.half())
    spp = sellp.sellp_from_scipy(A).to(cuda_device)
    x3p = spmv_sell.x_panes(torch.zeros(A.shape[1], device=cuda_device),
                            spp.n_panes)
    with pytest.raises(ValueError):
        sellp.sellp_out_panes(spp, x3p.transpose(1, 2).contiguous()
                              .transpose(1, 2))
    with pytest.raises(ValueError):
        sellp.sellp_out_panes(spp, x3p.cpu())


# ---- sort (K8-K10) and histogram (K15) -------------------------------------

FLIP = -(2 ** 31)


def _keys(n, seed=5, dev="cpu"):
    x = np.random.default_rng(seed).integers(0, 2**32, size=n,
                                             dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(dev)


def _region(buf, pad, n):
    return buf.reshape(-1)[pad:pad + n]


def _sorted_bits(bits):
    """The u32 sort of int32 bit patterns, as int32 bit patterns."""
    return torch.sort(bits ^ FLIP).values ^ FLIP


@pytest.mark.parametrize("alternate,invert,unflip", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)])
@pytest.mark.parametrize("log2c,n_chunks", [(1, 6), (7, 3), (10, 5),
                                            (13, 2), (13, 1)])
def test_chunk_kernel_matches_plain(cuda_device, log2c, n_chunks, alternate,
                                    invert, unflip):
    from libhpc_tpu_torch.ops import sort_merge as sm

    P = n_chunks << log2c
    x = _keys(P, seed=log2c, dev=cuda_device)
    pad_rows = 3
    rows = pad_rows + -(-P // 128) + 2
    kw = dict(log2c=log2c, alternate=alternate, invert=invert, unflip=unflip)
    n0 = sm.CHUNK_LAUNCHES
    got = sm.chunk_sort_kernel(x, pad_rows, rows, **kw)
    assert sm.CHUNK_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = sm._chunk_sort_torch(x, pad_rows, rows, **kw)
    assert torch.equal(_region(got, pad_rows * 128, P),
                       _region(want, pad_rows * 128, P))


@pytest.mark.parametrize("n", [1, 4000, 3 * 8192 + 77])
@pytest.mark.parametrize("log2c", [10, 13])
def test_chunk_kernel_pads_a_short_input(cuda_device, log2c, n):
    """K8 reads the keys past a short input's end as 0xFFFFFFFF: equal to
    the plain version on the padded keys."""
    from libhpc_tpu_torch.ops import sort_merge as sm

    P = 4 << 13
    x = _keys(n, seed=n, dev=cuda_device)
    padded = torch.cat([x, x.new_full((P - n,), -1)])
    kw = dict(log2c=log2c, alternate=True, invert=False, unflip=False)
    rows = 3 + P // 128 + 2
    got = sm.chunk_sort_kernel(x, 3, rows, P=P, **kw)
    torch.cuda.synchronize()
    want = sm._chunk_sort_torch(padded, 3, rows, **kw)
    assert torch.equal(_region(got, 384, P), _region(want, 384, P))


@pytest.mark.parametrize("alternate,invert,unflip", [
    (True, False, False), (False, True, True)])
def test_staged_chunk_sort_on_card(cuda_device, alternate, invert, unflip):
    """Chunks of 2^16 (the reference's default): 2^LOG2C_KERNEL
    sub-chunks by K8, then 16 - LOG2C_KERNEL merge levels by K9."""
    P = (3 if alternate else 1) << 16
    x = _keys(P, seed=7, dev=cuda_device)
    rows = (2 * (1 << 17) + P + 2048) // 128
    kw = dict(log2c=16, alternate=alternate, invert=invert, unflip=unflip)
    c0, m0 = sm.CHUNK_LAUNCHES, sm.MERGE_LAUNCHES
    got = sm._chunk_sort(x, 1024, rows, **kw)
    assert (sm.CHUNK_LAUNCHES, sm.MERGE_LAUNCHES) == (
        c0 + 1, m0 + 16 - sm.LOG2C_KERNEL)
    want = sm._chunk_sort_torch(x, 1024, rows, **kw)
    assert torch.equal(_region(got, 1 << 17, P), _region(want, 1 << 17, P))


DIRECTIONS = [(True, False, False), (True, True, True), (False, True, False),
              (False, False, True)]


def _chunk_case(kind, log2c, dev, seed=0):
    """Three chunks of `kind` keys (the last one short: its tail is the
    pad) and distinct payloads, on the card."""
    P = 3 << log2c
    n = P - max(1, (1 << log2c) // 3)
    keys = chunk_keys(kind, n, sm.RADIX_BITS, seed=seed + log2c)
    x = torch.from_numpy(keys.view(np.int32)).to(dev)
    v = torch.arange(n, dtype=torch.int32, device=dev) * 3 - 5
    return x, v, P


@pytest.mark.parametrize("log2c", range(1, sm.LOG2C_KERNEL + 1))
@pytest.mark.parametrize("kind", CHUNK_KEY_KINDS)
def test_chunk_kernel_key_kinds(cuda_device, kind, log2c):
    """K8 exactly as its plain version on ties, extremes, runs and keys
    that differ in one digit of each pass, at every chunk size it takes,
    every direction case, the last chunk padded."""
    x, _, P = _chunk_case(kind, log2c, cuda_device)
    rows = 2 + -(-P // 128) + 2
    for alternate, invert, unflip in DIRECTIONS:
        kw = dict(log2c=log2c, alternate=alternate, invert=invert,
                  unflip=unflip, P=P)
        got = sm.chunk_sort_kernel(x, 2, rows, **kw)
        want = sm._chunk_sort_torch(x, 2, rows, **kw)
        assert torch.equal(_region(got, 256, P), _region(want, 256, P))


@pytest.mark.parametrize("log2c", range(1, kv.LOG2C_KERNEL + 1))
@pytest.mark.parametrize("kind", CHUNK_KEY_KINDS)
def test_chunk_kv_kernel_key_kinds(cuda_device, kind, log2c):
    """K11 as K8 above, payloads exactly too: the block radix sort is
    stable and a descending chunk is the mirror image of the ascending
    one, as the plain version's stable sort and flip."""
    x, v, P = _chunk_case(kind, log2c, cuda_device, seed=1)
    rows = 2 + -(-P // 128) + 2
    for alternate, invert, unflip in DIRECTIONS:
        kw = dict(log2c=log2c, alternate=alternate, invert=invert,
                  unflip=unflip, P=P)
        gk, gv = kv.chunk_sort_kv_kernel(x, v, 2, rows, **kw)
        wk, wv = kv._chunk_sort_kv_torch(x, v, 2, rows, **kw)
        assert torch.equal(_region(gk, 256, P), _region(wk, 256, P))
        assert torch.equal(_region(gv, 256, P), _region(wv, 256, P))


def test_chunk_kernel_raises_without_an_instance(cuda_device, monkeypatch):
    """A digit width with no instance: the C entry points refuse it and
    the wrappers raise, for keys and for keys with payloads."""
    x, v, P = _chunk_case("random", 8, cuda_device)
    kw = dict(log2c=8, alternate=True, invert=False, unflip=False, P=P)
    rows = 2 + -(-P // 128) + 2
    monkeypatch.setattr(sm, "RADIX_BITS", 7)
    with pytest.raises(RuntimeError, match="sort_chunk_i32"):
        sm.chunk_sort_kernel(x, 2, rows, **kw)
    with pytest.raises(RuntimeError, match="sort_chunk_kv_i32"):
        kv.chunk_sort_kv_kernel(x, v, 2, rows, **kw)


@pytest.mark.parametrize("kv_sort", [False, True])
@pytest.mark.parametrize("bits", [4, 5, 6])
def test_chunk_kernel_instances(cuda_device, monkeypatch, bits, kv_sort):
    """Every digit width of the kernel (what chip_smoke.py's
    chunk_sort_sweep times) exactly as the plain version, up to the
    largest chunk it takes (2^14)."""
    mod = kv if kv_sort else sm
    monkeypatch.setattr(sm, "RADIX_BITS", bits)
    monkeypatch.setattr(mod, "LOG2C_KERNEL", 14)
    for log2c in (4, 11, 13, 14):
        x, v, P = _chunk_case("random", log2c, cuda_device, seed=bits)
        x[:5] = -1
        rows = 2 + -(-P // 128) + 2
        for alternate, invert, unflip in DIRECTIONS[:2]:
            kw = dict(log2c=log2c, alternate=alternate, invert=invert,
                      unflip=unflip, P=P)
            if kv_sort:
                got = kv.chunk_sort_kv_kernel(x, v, 2, rows, **kw)
                want = kv._chunk_sort_kv_torch(x, v, 2, rows, **kw)
            else:
                got = (sm.chunk_sort_kernel(x, 2, rows, **kw),)
                want = (sm._chunk_sort_torch(x, 2, rows, **kw),)
            for g, w in zip(got, want):
                assert torch.equal(_region(g, 256, P), _region(w, 256, P))


@pytest.mark.parametrize("invert,unflip", [(False, False), (True, True)])
@pytest.mark.parametrize("log2r,n_pairs,ties", [(10, 3, False), (10, 1, True),
                                                (12, 5, True),
                                                (14, 2, False)])
def test_merge_level_kernel_matches_plain(cuda_device, log2r, n_pairs, ties,
                                          invert, unflip):
    from libhpc_tpu_torch.ops import sort_merge as sm

    P = n_pairs << (log2r + 1)
    x = _keys(P, seed=log2r, dev=cuda_device)
    if ties:
        x = x % 37
    PAD = 1 << 15
    rows = (2 * PAD + P + 2048) // 128
    runs = sm._chunk_sort_torch(x, PAD // 128, rows, log2c=log2r,
                                alternate=True, invert=False, unflip=False)
    n0 = sm.MERGE_LAUNCHES
    got = sm._merge_level(runs, P, PAD, rows, log2r, min(17, log2r),
                          invert, unflip)
    assert sm.MERGE_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = sm._merge_level_torch(runs, P, PAD, rows, log2r, min(17, log2r),
                                 invert, unflip)
    assert torch.equal(_region(got, PAD, P), _region(want, PAD, P))


@pytest.mark.parametrize("desc_out,unflip", [(True, False), (False, True)])
@pytest.mark.parametrize("LA,LB,ties", [(1 << 14, 1 << 12, False),
                                        (1 << 12, 1 << 13, True),
                                        (1 << 16, 1 << 16, False)])
def test_merge_pair_kernel_matches_plain(cuda_device, LA, LB, ties,
                                         desc_out, unflip):
    from libhpc_tpu_torch.ops import sort_merge as sm

    a, b = _keys(LA, 1, cuda_device), _keys(LB, 2, cuda_device)
    if ties:
        a, b = a % 11, b % 11
    bufA, PAD = sm._sort_segment(a, 10, 12, invert=False, unflip=False)
    bufB, _ = sm._sort_segment(b, 10, 12, invert=True, unflip=False)
    lw = min(12, ((LA + LB) & -(LA + LB)).bit_length() - 1)
    m0, p0 = sm.MERGE_LAUNCHES, sm.PAIR_LAUNCHES
    got = sm._merge_pair(bufA, bufB, LA, LB, PAD, lw, desc_out, unflip)
    assert (sm.MERGE_LAUNCHES, sm.PAIR_LAUNCHES) == (m0 + 1, p0 + 1)
    torch.cuda.synchronize()
    want = sm._merge_pair_torch(bufA, bufB, LA, LB, PAD, lw, desc_out,
                                unflip)
    assert torch.equal(_region(got, PAD, LA + LB),
                       _region(want, PAD, LA + LB))


def _split_keys(kind, n, seed, dev):
    """Keys for the split search: random; few values (ties at every run's
    maximum); all equal; or many 0xFFFFFFFF (the +inf fill) among few."""
    x = _keys(n, seed, dev)
    if kind == "ties":
        return x % 5
    if kind == "equal":
        return torch.full_like(x, 0x1234)
    if kind == "top":
        return torch.where(x % 3 == 0, -1, x % 7)
    return x


SPLIT_KINDS = ["random", "ties", "equal", "top"]


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("kind", SPLIT_KINDS)
@pytest.mark.parametrize("log2r,n_pairs,log2w", [
    (10, 3, 10), (12, 5, 12), (14, 2, 12), (13, 1, 11), (5, 4, 6),
    (16, 2, 12)])
def test_split_kernel_matches_plain_level(cuda_device, log2r, n_pairs,
                                          log2w, kind, invert):
    """The split kernel's eight arrays equal _level_plan_torch's (the
    seven of _level_scalars and the A-counts) exactly."""
    from libhpc_tpu_torch.ops import sort_merge as sm

    P = n_pairs << (log2r + 1)
    x = _split_keys(kind, P, log2r, cuda_device)
    PAD = 1 << 15
    rows = (2 * PAD + P + 2048) // 128
    runs = sm._chunk_sort_torch(x, PAD // 128, rows, log2c=log2r,
                                alternate=True, invert=False, unflip=False)
    n0 = sm.SPLIT_LAUNCHES
    got = sm._level_plan(runs, P, PAD, log2r, log2w, invert)
    assert sm.SPLIT_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = sm._level_plan_torch(runs, P, PAD, log2r, log2w, invert)
    assert got.shape == want.shape == (8, P >> log2w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("desc_out", [False, True])
@pytest.mark.parametrize("kind", SPLIT_KINDS)
@pytest.mark.parametrize("LA,LB,log2w", [(1 << 14, 1 << 12, 12),
                                         (1 << 12, 1 << 13, 12),
                                         (1 << 16, 1 << 16, 12),
                                         (1 << 11, 1 << 15, 11),
                                         (1 << 5, 1 << 3, 3)])
def test_split_kernel_matches_plain_pair(cuda_device, LA, LB, log2w, kind,
                                         desc_out):
    """Ragged pair merges: A ascending, B descending, split arrays equal
    _pair_plan_torch's exactly."""
    from libhpc_tpu_torch.ops import sort_merge as sm

    PAD = 1 << 12
    bufs = []
    for n, seed, inv in ((LA, 1, False), (LB, 2, True)):
        x = _split_keys(kind, n, seed, cuda_device)
        bufs.append(sm._chunk_sort_torch(
            x, PAD // 128, (2 * PAD + n + 2048) // 128,
            log2c=n.bit_length() - 1, alternate=False, invert=inv,
            unflip=False))
    n0 = sm.SPLIT_LAUNCHES
    got = sm._pair_plan(*bufs, LA, LB, PAD, log2w, desc_out)
    assert sm.SPLIT_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, sm._pair_plan_torch(*bufs, LA, LB, PAD, log2w,
                                                desc_out))
    assert int(got[7].sum()) == LA


@pytest.mark.parametrize("log2w", [1, 2, 3, 4, 5, 13])
def test_merge_kernel_window_sizes(cuda_device, monkeypatch, log2w):
    """The merge-path kernel at windows below one thread's 16 outputs and
    at its largest (2^13, 64 KB of keys and payloads), keys and kv, equal
    to the plain versions; every payload once."""
    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    monkeypatch.setattr(sm, "LOG2W_KERNEL", 13)
    log2r = max(log2w, 6)
    P = 3 << (log2r + 1)
    x = _keys(P, seed=log2w, dev=cuda_device) % 97
    v = torch.arange(P, dtype=torch.int32, device=cuda_device)
    PAD = 1 << 13
    rows = (2 * PAD + P + 2048) // 128
    for inv, unf in ((False, False), (True, True)):
        runs = sm._chunk_sort_torch(x, PAD // 128, rows, log2c=log2r,
                                    alternate=True, invert=False,
                                    unflip=False)
        got = sm._merge_level(runs, P, PAD, rows, log2r, log2w, inv, unf)
        want = sm._merge_level_torch(runs, P, PAD, rows, log2r, log2w, inv,
                                     unf)
        assert torch.equal(_region(got, PAD, P), _region(want, PAD, P))
        bk, bv = kv._chunk_sort_kv_torch(x, v, PAD // 128, rows,
                                         log2c=log2r, alternate=True,
                                         invert=False, unflip=False)
        gk, gv = kv._merge_level_kv(bk, bv, P, PAD, rows, log2r, log2w, inv,
                                    unf)
        wk, _ = kv._merge_level_kv_torch(bk, bv, P, PAD, rows, log2r, log2w,
                                         inv, unf)
        assert torch.equal(_region(gk, PAD, P), _region(wk, PAD, P))
        assert torch.equal(torch.sort(_region(gv, PAD, P)).values, v)


def test_split_and_merge_wrappers_raise_on_bad_input(cuda_device):
    from libhpc_tpu_torch.ops import sort_merge as sm

    x = _keys(4096, dev=cuda_device)
    buf = sm._chunk_sort_torch(x, 16, 64, log2c=10, alternate=True,
                               invert=False, unflip=False)
    with pytest.raises(ValueError):   # windows wider than a run pair
        sm._level_plan(buf, 4096, 2048, 10, 12, False)
    with pytest.raises(ValueError):   # runs that do not tile P
        sm._level_plan(buf, 3000, 2048, 10, 10, False)
    with pytest.raises(TypeError):
        sm._level_plan(buf.long(), 4096, 2048, 10, 10, False)
    with pytest.raises(ValueError):   # the search would read past the buffer
        sm._pair_plan(buf, buf, 8192, 4096, 2048, 10, True)
    plan = sm._level_plan(buf, 4096, 2048, 10, 10, False)
    with pytest.raises(ValueError):
        sm._merge_launch(buf, buf, plan[:7].contiguous(), 2048, 64, 10,
                         False, False)
    with pytest.raises(ValueError):
        sm._merge_launch(buf, buf, plan.cpu(), 2048, 64, 10, False, False)


@pytest.mark.parametrize("n,log2c,log2w", [
    (1, 10, 11), (111, 10, 11), (3987, 10, 11), (5120, 10, 11),
    (11300, 10, 11), (100_003, 10, 11), (3000, 16, 17),
    ((1 << 20) + 7, 16, 17), (5_000_000, 16, 17)])
def test_merge_sort_on_card(cuda_device, n, log2c, log2w):
    from libhpc_tpu_torch.ops import sort_merge as sm

    x = _keys(n, seed=n % 1000, dev=cuda_device)
    c0, m0 = sm.CHUNK_LAUNCHES, sm.MERGE_LAUNCHES
    got = sm.merge_sort_u32(x.view(torch.uint32), log2c=log2c, log2w=log2w)
    assert got.dtype == torch.uint32 and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), _sorted_bits(x))
    if n > 1:
        assert sm.CHUNK_LAUNCHES > c0 and sm.MERGE_LAUNCHES >= m0
    if n <= 200_000:   # the CPU path (plain versions) agrees
        cpu = sm.merge_sort_u32(x.cpu(), log2c=log2c, log2w=log2w)
        assert torch.equal(got.cpu().view(torch.int32),
                           cpu.view(torch.int32))


@pytest.mark.parametrize("n", [1, 111, 50_000, (1 << 20) + 3])
def test_radix_and_bitonic_on_card(cuda_device, n):
    from libhpc_tpu_torch.ops import sort as srt

    x = _keys(n, seed=3, dev=cuda_device)
    want = _sorted_bits(x)
    for fn in (srt.radix_sort_pipeline, srt.bitonic_sort, srt.sort_u32):
        got = fn(x.view(torch.uint32))
        assert got.device.type == "cuda"
        assert torch.equal(got.view(torch.int32), want), fn.__name__
    s, order = srt.argsort_u32(x)
    assert torch.equal(x[order.long()], s.view(torch.int32))


@pytest.mark.parametrize("n_bins", [1, 16, 256, 4096, 1 << 15])
@pytest.mark.parametrize("n", [1, 111, 3987, 262_201, 10_000_003])
def test_histogram_kernel_matches_plain(cuda_device, n, n_bins):
    from libhpc_tpu_torch.ops import histogram as hist

    rng = np.random.default_rng(n)
    x = rng.integers(-3, n_bins + 3, size=n).astype(np.int32)
    xt = torch.from_numpy(x).to(cuda_device)
    n0 = hist.HIST_LAUNCHES
    got = hist.histogram_pallas(xt, n_bins)
    assert hist.HIST_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n_bins,)
    assert torch.equal(got, hist.histogram_pallas_torch(xt, n_bins))
    want = np.bincount(x[(x >= 0) & (x < n_bins)], minlength=n_bins)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_histogram_kernel_few_values(cuda_device):
    """Every element in one bin: the shared-memory atomics all collide."""
    from libhpc_tpu_torch.ops import histogram as hist

    x = torch.full((3_000_001,), 7, dtype=torch.int32, device=cuda_device)
    got = hist.histogram_pallas(x, 256)
    assert int(got[7]) == 3_000_001 and int(got.sum()) == 3_000_001


def test_sort_wrappers_raise_on_bad_input(cuda_device):
    from libhpc_tpu_torch.ops import histogram as hist
    from libhpc_tpu_torch.ops import sort_merge as sm

    x = _keys(4096, dev=cuda_device)
    kw = dict(alternate=True, invert=False, unflip=False)
    with pytest.raises(TypeError):
        sm.chunk_sort_kernel(x.long(), 0, 40, log2c=10, **kw)
    with pytest.raises(ValueError):
        sm.chunk_sort_kernel(x, 0, 40, log2c=14, **kw)
    with pytest.raises(ValueError):
        sm.chunk_sort_kernel(x[:3000], 0, 40, log2c=10, **kw)
    with pytest.raises(ValueError):
        sm.chunk_sort_kernel(x[::2], 0, 40, log2c=10, **kw)
    buf = sm._chunk_sort_torch(x, 16, 64, log2c=10, **kw)
    with pytest.raises(ValueError):
        sm._merge_pair(buf, buf.cpu(), 2048, 2048, 2048, 10, True, False)
    with pytest.raises(TypeError):
        sm._merge_level(buf.long(), 4096, 2048, 64, 10, 10, False, False)
    with pytest.raises(TypeError):
        hist.histogram_pallas(x.float(), 256)
    with pytest.raises(ValueError):
        hist.histogram_pallas(x, (1 << 15) + 1)
    with pytest.raises(ValueError):
        hist.histogram_pallas(x.reshape(64, 64)[:, :8], 256)


# ---- key-value sort (K11, K12) and scans (K13, K14) -------------------------


def _pairs(keys, vals):
    """(key, payload) pairs packed into int64 and sorted: equal for two
    results of an unstable sort that moved every payload with its key."""
    k = keys.reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    v = vals.reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    return torch.sort((k << 32) | v).values


@pytest.mark.parametrize("alternate,invert,unflip", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)])
@pytest.mark.parametrize("log2c,n_chunks", [(1, 6), (7, 3), (12, 5),
                                            (13, 2), (13, 1)])
def test_chunk_kv_kernel_matches_plain(cuda_device, log2c, n_chunks,
                                       alternate, invert, unflip):
    """K11 on distinct keys: keys and payloads exactly as the stable plain
    version."""
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    P = n_chunks << log2c
    x = torch.randperm(1 << 20, device=cuda_device)[:P].to(torch.int32) - 7
    v = _keys(P, seed=log2c, dev=cuda_device)
    rows = 3 + -(-P // 128) + 2
    kw = dict(log2c=log2c, alternate=alternate, invert=invert, unflip=unflip)
    n0 = kv.CHUNK_LAUNCHES
    gk, gv = kv.chunk_sort_kv_kernel(x, v, 3, rows, **kw)
    assert kv.CHUNK_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    wk, wv = kv._chunk_sort_kv_torch(x, v, 3, rows, **kw)
    assert torch.equal(_region(gk, 384, P), _region(wk, 384, P))
    assert torch.equal(_region(gv, 384, P), _region(wv, 384, P))


def test_chunk_kv_kernel_ties(cuda_device):
    """K11 with ties: keys exactly, payloads as pairs."""
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    P = 4 << 13
    x = _keys(P, seed=3, dev=cuda_device) % 5
    v = torch.arange(P, dtype=torch.int32, device=cuda_device)
    kw = dict(log2c=13, alternate=True, invert=False, unflip=False)
    gk, gv = kv.chunk_sort_kv_kernel(x, v, 0, P // 128, **kw)
    wk, wv = kv._chunk_sort_kv_torch(x, v, 0, P // 128, **kw)
    assert torch.equal(gk, wk)
    assert torch.equal(_pairs(gk, gv), _pairs(wk, wv))


@pytest.mark.parametrize("n", [1, 4000, 3 * 8192 + 77])
@pytest.mark.parametrize("log2c", [10, 13])
def test_chunk_kv_kernel_pads_a_short_input(cuda_device, log2c, n):
    """K11 reads the keys past a short input's end as 0xFFFFFFFF with
    payload 0: equal to the plain version on the padded keys and
    payloads."""
    P = 4 << 13
    x = _keys(n, seed=n, dev=cuda_device)
    v = torch.arange(1, n + 1, dtype=torch.int32, device=cuda_device)
    kw = dict(log2c=log2c, alternate=True, invert=False, unflip=False)
    rows = 3 + P // 128 + 2
    gk, gv = kv.chunk_sort_kv_kernel(x, v, 3, rows, P=P, **kw)
    torch.cuda.synchronize()
    wk, wv = kv._chunk_sort_kv_torch(torch.cat([x, x.new_full((P - n,), -1)]),
                                     torch.cat([v, v.new_zeros(P - n)]), 3,
                                     rows, **kw)
    assert torch.equal(_region(gk, 384, P), _region(wk, 384, P))
    assert torch.equal(_region(gv, 384, P), _region(wv, 384, P))


@pytest.mark.parametrize("invert,unflip", [(False, False), (True, True)])
@pytest.mark.parametrize("log2r,n_pairs,ties", [(10, 3, False), (10, 1, True),
                                                (12, 5, True),
                                                (14, 2, False)])
def test_merge_level_kv_kernel_matches_plain(cuda_device, log2r, n_pairs,
                                             ties, invert, unflip):
    """K12 as a level; ties include keys equal to the +inf fill of both
    window directions (0xFFFFFFFF and 0)."""
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    P = n_pairs << (log2r + 1)
    if ties:
        x = _keys(P, seed=log2r, dev=cuda_device) % 3 - 1
    else:
        x = torch.randperm(1 << 24, device=cuda_device)[:P].to(torch.int32)
    v = torch.arange(P, dtype=torch.int32, device=cuda_device) * 3
    PAD = 1 << 15
    rows = (2 * PAD + P + 2048) // 128
    bk, bv = kv._chunk_sort_kv_torch(x, v, PAD // 128, rows, log2c=log2r,
                                     alternate=True, invert=False,
                                     unflip=False)
    lw = min(17, log2r)
    n0 = kv.MERGE_LAUNCHES
    gk, gv = kv._merge_level_kv(bk, bv, P, PAD, rows, log2r, lw, invert,
                                unflip)
    assert kv.MERGE_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    wk, wv = kv._merge_level_kv_torch(bk, bv, P, PAD, rows, log2r, lw,
                                      invert, unflip)
    gk, gv = _region(gk, PAD, P), _region(gv, PAD, P)
    wk, wv = _region(wk, PAD, P), _region(wv, PAD, P)
    assert torch.equal(gk, wk)
    if ties:
        assert torch.equal(_pairs(gk, gv), _pairs(wk, wv))
        assert torch.equal(torch.sort(gv).values, v)
    else:
        assert torch.equal(gv, wv)


@pytest.mark.parametrize("desc_out,unflip", [(True, False), (False, True)])
@pytest.mark.parametrize("LA,LB,ties", [(1 << 14, 1 << 12, False),
                                        (1 << 12, 1 << 13, True),
                                        (1 << 16, 1 << 16, False)])
def test_merge_pair_kv_kernel_matches_plain(cuda_device, LA, LB, ties,
                                            desc_out, unflip):
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    perm = torch.randperm(1 << 24, device=cuda_device).to(torch.int32)
    a, b = perm[:LA], perm[LA:LA + LB]
    if ties:
        a, b = a % 3 - 1, b % 3 - 1
    va = torch.arange(LA, dtype=torch.int32, device=cuda_device)
    vb = torch.arange(LA, LA + LB, dtype=torch.int32, device=cuda_device)
    ak, av = kv._sort_segment_kv(a, va, 10, 12, invert=False, unflip=False)
    bk, bv = kv._sort_segment_kv(b, vb, 10, 12, invert=True, unflip=False)
    PAD = 1 << 12
    lw = min(12, ((LA + LB) & -(LA + LB)).bit_length() - 1)
    m0, p0 = kv.MERGE_LAUNCHES, kv.PAIR_LAUNCHES
    gk, gv = kv._merge_pair_kv(ak, av, bk, bv, LA, LB, PAD, lw, desc_out,
                               unflip)
    assert (kv.MERGE_LAUNCHES, kv.PAIR_LAUNCHES) == (m0 + 1, p0 + 1)
    torch.cuda.synchronize()
    wk, wv = kv._merge_pair_kv_torch(ak, av, bk, bv, LA, LB, PAD, lw,
                                     desc_out, unflip)
    n = LA + LB
    gk, gv = _region(gk, PAD, n), _region(gv, PAD, n)
    wk, wv = _region(wk, PAD, n), _region(wv, PAD, n)
    assert torch.equal(gk, wk)
    assert torch.equal(_pairs(gk, gv), _pairs(wk, wv))
    if not ties:
        assert torch.equal(gv, wv)


@pytest.mark.parametrize("n,log2c,log2w", [
    (1, 10, 11), (111, 10, 11), (700, 10, 11), (3000, 10, 11),
    (3987, 10, 11), (11300, 10, 11), (100_003, 10, 11), (3000, 15, 17),
    ((1 << 20) + 7, 15, 17), (5_000_000, 15, 17)])
def test_merge_sort_kv_on_card(cuda_device, n, log2c, log2w):
    """merge_sort_kv_u32 with keys of a small alphabet holding 0, the sign
    boundary and 0xFFFFFFFF: keys exactly as torch.sort's, every payload
    once beside its own key; merge_argsort_u32 on distinct-ish keys."""
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    alphabet = torch.tensor([0, 5, 0x7FFFFFFF, -2**31, -1], dtype=torch.int32,
                            device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    k = alphabet[torch.randint(0, 5, (n,), device=cuda_device, generator=g)]
    v = torch.rand(n, device=cuda_device, generator=g)
    c0 = kv.CHUNK_LAUNCHES
    ks, vs = kv.merge_sort_kv_u32(k.view(torch.uint32), v, log2c=log2c,
                                  log2w=log2w)
    assert ks.dtype == torch.uint32 and vs.dtype == torch.float32
    assert ks.device.type == vs.device.type == "cuda"
    assert torch.equal(ks.view(torch.int32), _sorted_bits(k))
    assert torch.equal(_pairs(ks, vs), _pairs(k, v))
    if n > 1:
        assert kv.CHUNK_LAUNCHES > c0
    x = _keys(n, seed=n % 997, dev=cuda_device)
    s, order = kv.merge_argsort_u32(x, log2c=log2c, log2w=log2w)
    assert order.dtype == torch.int32
    assert torch.equal(s.view(torch.int32), _sorted_bits(x))
    assert torch.equal(x[order.long()], s.view(torch.int32))
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("n", [1, 111, 4095, 4096, 4097, 8191, 8192, 8193,
                               3 * 8192, 262_201, 1 << 24, (1 << 24) + 3,
                               (1 << 24) + 5, 30_000_001])
def test_scan_kernels_match_plain(cuda_device, hang_guard, n):
    """K14 exactly against its plain version and int64 cumsum, and bit for
    bit the same on a second run; K13 within rtol/atol 1e-4 of a float64
    oracle and of its plain version. Sizes: one tile or less, exact
    multiples of the 8192-element tile and ragged ones, and many more tiles
    than blocks (2^24 + 3: 2049 tiles for the ~264 persistent blocks)."""
    from libhpc_tpu_torch.ops import scan

    g = torch.Generator(device=cuda_device).manual_seed(n)
    xi = torch.randint(0, 1000, (n,), dtype=torch.int32, device=cuda_device,
                       generator=g)
    i0, f0 = scan.SCAN_INT_LAUNCHES, scan.SCAN_F32_LAUNCHES
    got = scan.exclusive_scan_pallas(xi)
    assert got.dtype == torch.int32
    assert torch.equal(got, scan._exclusive_scan_int_torch(xi))
    # int32 sums wrap past 2^31 (n >= 2^24 here)
    want = (torch.cumsum(xi, 0, dtype=torch.int64) - xi).to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(scan.exclusive_scan_pallas(xi), got)
    xf = torch.rand(n, device=cuda_device, generator=g)
    gf = scan.exclusive_scan_pallas(xf)
    assert (scan.SCAN_INT_LAUNCHES, scan.SCAN_F32_LAUNCHES) == (i0 + 2, f0 + 1)
    oracle = (torch.cumsum(xf.double(), 0) - xf.double()).float()
    torch.testing.assert_close(gf, oracle, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gf, scan._exclusive_scan_f32_torch(xf),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [5, 4097, 100_003])
def test_scan_kernel_unaligned_input(cuda_device, hang_guard, n):
    """A view one element into its storage takes the kernel's element-wise
    loads: the same sums as the aligned copy (int32 exactly)."""
    from libhpc_tpu_torch.ops import scan

    g = torch.Generator(device=cuda_device).manual_seed(n)
    base = torch.randint(-1000, 1000, (n + 1,), dtype=torch.int32,
                         device=cuda_device, generator=g)
    x = base[1:]
    assert x.data_ptr() % 16 != 0
    assert torch.equal(scan.exclusive_scan_pallas(x),
                       scan._exclusive_scan_int_torch(x.clone()))
    xf = base[1:].float()[1:]
    torch.testing.assert_close(scan.exclusive_scan_pallas(xf),
                               scan._exclusive_scan_f32_torch(xf), rtol=1e-4,
                               atol=1e-4)


def test_scan_kernel_wraps_and_narrow_dtypes(cuda_device):
    """Sums past 2^31 wrap as int32 adds do; narrower integers wrap in
    their own dtype; int64 and float64 are refused."""
    from libhpc_tpu_torch.ops import scan

    x = torch.full((5_000_001,), 2**30, dtype=torch.int32, device=cuda_device)
    got = scan.exclusive_scan_pallas(x)
    assert torch.equal(got, scan._exclusive_scan_int_torch(x))
    assert got[:5].tolist() == [0, 2**30, -2**31, -2**30, 0]
    for dt in (torch.int8, torch.uint8, torch.int16, torch.uint32):
        y = (torch.arange(10_000, device=cuda_device) % 200).to(dt)
        assert torch.equal(scan.exclusive_scan_pallas(y).cpu(),
                           scan.exclusive_scan_pallas(y.cpu()))
    for dt in (torch.int64, torch.float64):
        with pytest.raises(TypeError):
            scan.exclusive_scan_pallas(torch.zeros(10, dtype=dt,
                                                   device=cuda_device))


def test_kv_and_scan_wrappers_raise_on_bad_input(cuda_device):
    from libhpc_tpu_torch.ops import scan
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    x = _keys(4096, dev=cuda_device)
    kw = dict(alternate=True, invert=False, unflip=False)
    with pytest.raises(ValueError):
        kv.chunk_sort_kv_kernel(x, x.cpu(), 0, 40, log2c=10, **kw)
    with pytest.raises(TypeError):
        kv.chunk_sort_kv_kernel(x, x.float(), 0, 40, log2c=10, **kw)
    with pytest.raises(ValueError):
        kv.chunk_sort_kv_kernel(x, x, 0, 40, log2c=14, **kw)
    bk, bv = kv._chunk_sort_kv_torch(x, x, 16, 64, log2c=10, **kw)
    with pytest.raises(TypeError):
        kv._merge_level_kv(bk, bv.float(), 4096, 2048, 64, 10, 10, False,
                           False)
    with pytest.raises(ValueError):
        kv.merge_sort_kv_u32(x, x[:-1])
    with pytest.raises(ValueError):
        scan._exclusive_scan_f32(torch.zeros(64, device=cuda_device)[::2])
    with pytest.raises(TypeError):
        scan._exclusive_scan_int(torch.zeros(64, device=cuda_device))


def test_entry_points_default_to_the_card(cuda_device):
    """Builders and numpy inputs given no device land on the card."""
    from libhpc_tpu_torch.ops import scan, sort, sort_merge
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    A = matrices.poisson2d(64)
    assert SBELL.from_scipy(A).device.type == "cuda"
    assert DIA.from_scipy(A).to_pallas(T=1 << 13).device.type == "cuda"
    assert spmv_sell.sell_from_scipy(A).device.type == "cuda"
    assert sellp.sellp_from_scipy(A).device.type == "cuda"
    c, _ = auto.auto_format(A)
    assert c.device.type == "cuda"
    x = np.random.default_rng(0).integers(0, 2**32, 5000, dtype=np.uint32)
    assert sort_merge.merge_sort_u32(x, 10, 11).device.type == "cuda"
    assert kv.merge_argsort_u32(x, 10, 11)[1].device.type == "cuda"
    assert scan.exclusive_scan_pallas(x.view(np.int32)).device.type == "cuda"
    assert sort.is_sorted(np.sort(x)).device.type == "cuda"


# ---- the dense-array, stencil and grid layer (K16-K19) ---------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("shape", [(1, 1), (8, 128), (100, 300), (257, 129),
                                   (3, 1001), (4097, 33), (2, 65_537)])
def test_row_sum_kernel_matches_plain(cuda_device, shape, dtype):
    """K16 on ragged shapes (1001 and 33 columns take the kernel's scalar
    path, the others its 16-byte loads): int32 exactly (wrapping), floats
    to 1e-5 of the plain version (bf16: one bf16 rounding)."""
    from libhpc_tpu_torch.ops import reduce as red

    g = torch.Generator(device=cuda_device).manual_seed(shape[0])
    if dtype == torch.int32:
        x = torch.randint(-2**31, 2**31, shape, dtype=dtype,
                          device=cuda_device, generator=g)
    else:
        x = torch.rand(shape, device=cuda_device, generator=g).to(dtype)
    n0 = red.ROW_SUM_LAUNCHES
    got = red.row_sum_pallas(x)
    assert red.ROW_SUM_LAUNCHES == n0 + 1
    assert got.dtype == dtype and got.shape == (shape[0],)
    want = red.row_sum_pallas_torch(x)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=0)
    else:
        _close(got, want)
        torch.testing.assert_close(got.double(), x.double().sum(1),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.int8, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1), (31, 33), (100, 300), (257, 513),
                                   (1000, 3), (2048, 1024)])
def test_transpose_kernel_matches_plain(cuda_device, shape, dtype):
    """K17 exactly against x.t() for words of 1, 2, 4 and 8 bytes."""
    from libhpc_tpu_torch.ops import transpose as tr

    x = torch.arange(shape[0] * shape[1], device=cuda_device).reshape(shape)
    x = (x * 7 + 3).to(dtype)
    n0 = tr.TRANSPOSE_LAUNCHES
    got = tr.transpose_pallas(x)
    assert tr.TRANSPOSE_LAUNCHES == n0 + 1
    assert got.shape == shape[::-1] and got.dtype == dtype
    assert torch.equal(got, tr.transpose_pallas_torch(x))


def test_transpose_routing(cuda_device):
    """transpose(): every CUDA tensor of a 1/2/4/8-byte dtype goes through
    K17, whatever its shape."""
    from libhpc_tpu_torch.ops import transpose as tr

    cases = [((2048, 1024), torch.float32), ((1024, 1000), torch.float32),
             ((1024, 1024), torch.int32), ((300, 100), torch.float32),
             ((77, 130), torch.bfloat16), ((33, 65), torch.int64),
             ((9, 17), torch.uint8)]
    for shape, dtype in cases:
        x = torch.arange(shape[0] * shape[1], device=cuda_device).reshape(
            shape).to(dtype)
        n0 = tr.TRANSPOSE_LAUNCHES
        got = tr.transpose(x)
        assert tr.TRANSPOSE_LAUNCHES == n0 + 1, (shape, dtype)
        assert got.is_contiguous() and torch.equal(got, x.t())


@pytest.fixture
def hang_guard():
    """Ends the test process with a traceback if the test runs past 120 s:
    a tensor-core kernel whose barrier never completes would hang."""
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (100, 200, 50),
                                   (256, 512, 256), (300, 300, 300),
                                   (129, 1, 7), (1, 1000, 1), (130, 0, 5),
                                   (1030, 770, 513), (1024, 1024, 1024),
                                   (2048, 300, 1158)])
def test_matmul_kernel_matches_plain(cuda_device, hang_guard, m, k, n):
    """K18 in float32 (the FMA kernel after K17 on A: 64 x 64 tiles up to
    1024^2, 128 x 128 at 2048 x 1158) against its plain version and a
    float64 product at the reference test's tolerance (rtol 1e-4, atol
    1e-3); bfloat16 and float16 (the tensor-core kernel after K17 on B)
    against their plain version and the float32 product of the rounded
    operands, to one rounding of the output (1e-2). Every dtype makes one
    K17 and one K18 launch a call, none at K = 0. Operands are mean-zero,
    so that rounding errors do not average out and TF32 would miss the
    tolerance."""
    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import transpose as tr

    g = torch.Generator(device=cuda_device).manual_seed(m * 7 + n)
    a = torch.randn((m, k), device=cuda_device, generator=g)
    b = torch.randn((k, n), device=cuda_device, generator=g)
    n0, t0 = mm.MATMUL_LAUNCHES, tr.TRANSPOSE_LAUNCHES
    got = mm.matmul_pallas(a, b)
    torch.cuda.synchronize()
    step = int(k > 0)
    assert (mm.MATMUL_LAUNCHES, tr.TRANSPOSE_LAUNCHES) == (n0 + step,
                                                           t0 + step)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, mm.matmul_pallas_torch(a, b), rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(got.double(), a.double() @ b.double(),
                               rtol=1e-4, atol=1e-3)
    for dt in (torch.bfloat16, torch.float16):
        ah, bh = a.to(dt), b.to(dt)
        n0, t0 = mm.MATMUL_LAUNCHES, tr.TRANSPOSE_LAUNCHES
        got = mm.matmul_pallas(ah, bh)
        torch.cuda.synchronize()
        step = int(k > 0)
        assert (mm.MATMUL_LAUNCHES, tr.TRANSPOSE_LAUNCHES) == (n0 + step,
                                                               t0 + step)
        assert got.dtype == dt and got.shape == (m, n)
        torch.testing.assert_close(got.float(),
                                   mm.matmul_pallas_torch(ah, bh).float(),
                                   rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(got.float(), ah.float() @ bh.float(),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,k,n", [(128, 64, 128), (300, 200, 130)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
def test_matmul_tensor_cores_identity_and_one_hot(cuda_device, hang_guard,
                                                  dt, m, k, n):
    """Exact products that expose a wrong wgmma descriptor, swizzle or
    fragment layout (which give a transposed, shifted or half-zero C):
    I @ B is B's first rows, A @ I is A's first columns, and a one-hot B
    (a 1 at (p, q)) puts column p of A into column q of C."""
    from libhpc_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), device=cuda_device, generator=g).to(dt)
    b = torch.randn((k, n), device=cuda_device, generator=g).to(dt)
    eye = torch.eye(m, k, device=cuda_device, dtype=dt)
    want = torch.zeros((m, n), dtype=dt, device=cuda_device)
    want[:min(m, k)] = b[:min(m, k)]
    assert torch.equal(mm.matmul_pallas(eye, b), want)
    want = torch.zeros((m, n), dtype=dt, device=cuda_device)
    want[:, :min(k, n)] = a[:, :min(k, n)]
    assert torch.equal(
        mm.matmul_pallas(a, torch.eye(k, n, device=cuda_device, dtype=dt)),
        want)
    for p, q in ((0, 0), (k - 1, n - 1), (k // 2, n // 3), (63, 127 % n)):
        hot = torch.zeros((k, n), dtype=dt, device=cuda_device)
        hot[p, q] = 1
        want = torch.zeros((m, n), dtype=dt, device=cuda_device)
        want[:, q] = a[:, p]
        assert torch.equal(mm.matmul_pallas(a, hot), want), (p, q)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (67, 33, 130), (128, 16, 128),
                                   (130, 17, 259), (513, 1000, 4)])
def test_matmul_f32_tiles_match_plain(cuda_device, hang_guard, monkeypatch,
                                      tile, m, k, n):
    """Both tiles of the FMA kernel on every shape (fma_tile forced): edges
    of M and N inside a 16-byte copy and inside a tile, K past the last
    stage, against the plain version at rtol 1e-4, atol 1e-3; a one-hot B
    (a 1 at (p, q)) puts column p of A into column q of C exactly."""
    from libhpc_tpu_torch.ops import matmul as mm

    monkeypatch.setattr(mm, "fma_tile", lambda *args: tile)
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n + tile)
    a = torch.randn((m, k), device=cuda_device, generator=g)
    b = torch.randn((k, n), device=cuda_device, generator=g)
    torch.testing.assert_close(mm.matmul_pallas(a, b),
                               mm.matmul_pallas_torch(a, b), rtol=1e-4,
                               atol=1e-3)
    for p, q in ((0, 0), (k - 1, n - 1), (k // 2, n // 3)):
        hot = torch.zeros((k, n), device=cuda_device)
        hot[p, q] = 1
        want = torch.zeros((m, n), device=cuda_device)
        want[:, q] = a[:, p]
        assert torch.equal(mm.matmul_pallas(a, hot), want), (p, q)


def test_matmul_library_holds_hgmma(cuda_device):
    """The built kernel library runs wgmma: its SASS holds HGMMA."""
    assert _cuda_utils.count_sass("HGMMA") > 0


def _blur_case(a, r, mode):
    """K19 on `a` in load mode `mode` (asserted by its counter): within
    1e-5 of its plain version and of a float64 box sum; returns it."""
    from libhpc_tpu_torch.ops import stencil

    m, n = a.shape
    plan = stencil.blur_plan(m, n, r, a.data_ptr())
    assert plan.mode == mode
    n0 = stencil.BLUR_LAUNCHES
    n_tma, n_plain = stencil.BLUR_TMA_LAUNCHES, stencil.BLUR_PLAIN_LAUNCHES
    got = stencil.blur2d_pallas(a, r)
    torch.cuda.synchronize()
    assert stencil.BLUR_LAUNCHES == n0 + 1
    assert stencil.BLUR_TMA_LAUNCHES == n_tma + (mode == "tma")
    assert stencil.BLUR_PLAIN_LAUNCHES == n_plain + (mode == "plain")
    _close(got, stencil.blur2d_pallas_torch(a, r))
    exact = stencil.blur2d_pallas_torch(a.double(), r)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
    return got


# (shape, load mode): n % 4 == 0 takes TMA (torch's allocations are
# 16-byte aligned); m not a multiple of 32 (a stage) or 256 (a band), n not
# a multiple of 128 (a strip); (7, 8): one stage box past both edges
BLUR_SHAPES = [((1, 1), "plain"), ((64, 64), "tma"), ((100, 200), "tma"),
               ((300, 129), "plain"), ((1000, 70), "plain"),
               ((65, 4097), "plain"), ((1100, 388), "tma"),
               ((577, 1001), "plain"), ((7, 8), "tma")]


@pytest.mark.parametrize("r", [0, 1, 4, 8, 17, 64])
@pytest.mark.parametrize("shape,mode", BLUR_SHAPES)
def test_blur2d_kernel_matches_plain(cuda_device, shape, mode, r):
    """K19 adds in its plain version's order: equal to 1e-5; and within
    1e-5 of a float64 box sum, in both load modes."""
    from libhpc_tpu_torch.ops import stencil

    g = torch.Generator(device=cuda_device).manual_seed(shape[0] + r)
    a = torch.rand(shape, device=cuda_device, generator=g)
    got = _blur_case(a, r, mode)
    torch.testing.assert_close(got, stencil.blur2d(a, r), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("r", [1, 8, 64])
def test_blur2d_kernel_misaligned_view(cuda_device, r):
    """A view 4 bytes past an aligned allocation takes the plain loads,
    with n % 4 == 0."""
    m, n = 300, 256
    g = torch.Generator(device=cuda_device).manual_seed(r)
    a = torch.rand(m * n + 1, device=cuda_device, generator=g)[1:].view(m, n)
    assert a.data_ptr() % 16 == 4
    _blur_case(a, r, "plain")


@pytest.mark.parametrize("r", [17, 31])
def test_blur2d_kernel_runtime_radius_instance(cuda_device, r):
    """The runtime-r instance (every r in 4..64 but 8), over several bands
    of 1024 rows and strips, at an even and an odd strip shift."""
    g = torch.Generator(device=cuda_device).manual_seed(r)
    _blur_case(torch.rand((2100, 516), device=cuda_device, generator=g), r,
               "tma")


@pytest.mark.parametrize("n,mode", [(4, "tma"), (3, "plain")])
def test_blur2d_kernel_past_the_grid_y_limit(cuda_device, n, mode):
    """m = 2^22 + 65 rows: past 65,535 blocks of 64 rows, which a 2-D grid
    of 64-row tiles refused."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    a = torch.rand(((1 << 22) + 65, n), device=cuda_device, generator=g)
    _blur_case(a, 8, mode)


def test_dense_layer_wrappers_raise_on_bad_input(cuda_device):
    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import reduce as red
    from libhpc_tpu_torch.ops import stencil
    from libhpc_tpu_torch.ops import transpose as tr

    x = torch.rand((64, 64), device=cuda_device)
    with pytest.raises(TypeError):
        red.row_sum_pallas(x.double())
    with pytest.raises(TypeError):
        tr.transpose_pallas(x.to(torch.complex128))
    with pytest.raises(TypeError):
        mm.matmul_pallas(x, x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        mm.matmul_pallas(x.double(), x.double())
    with pytest.raises(ValueError):
        mm.matmul_pallas(x, x.cpu())
    with pytest.raises(TypeError):
        stencil.blur2d_pallas(x.double())
    with pytest.raises(ValueError):
        stencil.blur2d_pallas(x, stencil.MAX_KERNEL_RADIUS + 1)


def test_grid_on_card_matches_dense_oracle(cuda_device):
    """BlockGrid and NestedGrid on the card: unit writes (exact sums) equal
    a dense index_put_(accumulate=True) image, in raster and morton order,
    through write_batch and write_batch_dense."""
    from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n = 1 << 16
    xs = torch.randint(0, 512, (n,), device=cuda_device, generator=g)
    ys = torch.randint(0, 512, (n,), device=cuda_device, generator=g)
    ones = torch.ones(n, device=cuda_device)
    want = torch.zeros((512, 512), device=cuda_device).index_put_(
        (ys, xs), ones, accumulate=True)
    for order in ("raster", "morton"):
        grid = BlockGrid.create((32, 32), block_size=16, capacity=1024)
        assert grid.device.type == "cuda"
        grid = grid.touch_batch(xs, ys, order=order)
        assert int(grid.n_allocated()) == int((want.view(32, 16, 32, 16)
                                               .sum((1, 3)) > 0).sum())
        assert torch.equal(grid.write_batch(xs, ys, ones).todense(), want)
        assert torch.equal(grid.write_batch_dense(xs, ys, ones).todense(),
                           want)
    ng = NestedGrid.create((4, 4), mid_grid=(8, 8), block_size=16,
                           cap_mid=16, cap_leaf=1024)
    ng = ng.touch_batch(xs, ys).write_batch(xs, ys, ones)
    assert torch.equal(ng.todense(), want)
    assert torch.equal(ng.read_batch(xs, ys), want[ys, xs])


def test_dense_layer_entry_points_default_to_the_card(cuda_device):
    """numpy inputs given no device land on the card."""
    from libhpc_tpu_torch.containers import HaloArray
    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import reduce as red
    from libhpc_tpu_torch.ops import stencil
    from libhpc_tpu_torch.ops import transpose as tr
    from libhpc_tpu_torch.utils.morton import morton2d_encode

    a = np.random.default_rng(0).random((64, 48)).astype(np.float32)
    for out in (red.row_sum_pallas(a), red.tree_reduce_sum(a),
                red.segment_sum(a[:, 0], np.arange(64) % 4, 4),
                tr.transpose_pallas(a), tr.transpose(a),
                mm.matmul_pallas(a, a.T), stencil.blur2d_pallas(a),
                stencil.blur2d(a), stencil.poisson5_apply(a),
                morton2d_encode(np.arange(4), np.arange(4)),
                HaloArray.wrap(a, 1).data):
        assert out.device.type == "cuda"


# ---- the micro-architecture probes (K20, K21a-d) ---------------------------


@pytest.mark.parametrize("w", [0, 1, 2, 13, 64])
@pytest.mark.parametrize("rows", [2048, 3 * 2048 + 5, 512 * 2048])
def test_overlap_sweep_kernel_matches_plain(cuda_device, rows, w):
    """K20 folds every row: equal to its plain version to 1e-5 (both sum
    256 rows a block, in other orders; the kernel contracts to FMAs).
    512 blocks is the bench's 512 MB; trailing rows are ignored."""
    from libhpc_tpu_torch.bench import overlap_chip as oc

    g = torch.Generator(device=cuda_device).manual_seed(rows + w)
    x = torch.rand((rows, 128), device=cuda_device, generator=g)
    n0 = oc.SWEEP_LAUNCHES
    got = oc._sweep_step(x, w)
    assert oc.SWEEP_LAUNCHES == n0 + 1
    assert got.shape == (rows // 2048 * 8, 128)
    _close(got, oc._sweep_step_torch(x, w))


@pytest.mark.parametrize("S,n_tiles", [(1, 1), (8, 2), (37, 3), (1024, 16),
                                       (1000, 33)])
def test_lane_shuffle_kernel_matches_plain(cuda_device, S, n_tiles):
    from libhpc_tpu_torch.bench import microarch as ma

    g = torch.Generator(device=cuda_device).manual_seed(S * n_tiles)
    tab = torch.rand((S, 128), device=cuda_device, generator=g)
    idx = torch.randint(0, 128, (n_tiles * S, 128), device=cuda_device,
                        generator=g, dtype=torch.int32)
    n0 = ma.LANE_SHUFFLE_LAUNCHES
    got = ma.lane_shuffle(tab, idx)
    assert ma.LANE_SHUFFLE_LAUNCHES == n0 + 1
    assert torch.equal(got, ma.lane_shuffle_torch(tab, idx))


@pytest.mark.parametrize("n_table,n_gather,R,G", [
    (1, 1, 1, 1), (16, 32, 8, 8), (5, 17, 3, 5), (1 << 12, 1 << 14, 8, 256),
    (300, 1001, 8, 2), (64, 100, 65, 1)])
def test_dma_gather_kernel_matches_plain(cuda_device, n_table, n_gather, R,
                                         G):
    from libhpc_tpu_torch.bench import microarch as ma

    g = torch.Generator(device=cuda_device).manual_seed(n_gather + R)
    table = torch.rand((n_table * R, 128), device=cuda_device, generator=g)
    idx = torch.randint(0, n_table, (n_gather,), device=cuda_device,
                        generator=g, dtype=torch.int32)
    n0 = ma.DMA_GATHER_LAUNCHES
    got = ma.dma_gather(idx, table, R, G)
    assert ma.DMA_GATHER_LAUNCHES == n0 + 1
    assert torch.equal(got, ma.dma_gather_torch(idx, table, R))


@pytest.mark.parametrize("stages,stage_rows", [(2, 1), (3, 32), (4, 32),
                                               (8, 64), (2, 8)])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_dma_gather_ring_tails_and_clamps(cuda_device, hang_guard, R, stages,
                                          stage_rows):
    """K21b's bulk-copy ring at several shapes: 1003 gathers (a multiple of
    no ring's stages), gathers split over stages (stage_rows < R), and
    indices outside the table, clamped into it."""
    from libhpc_tpu_torch.bench import microarch as ma

    n_table, n_gather = 37, 1003
    g = torch.Generator(device=cuda_device).manual_seed(R * stages)
    table = torch.rand((n_table * R, 128), device=cuda_device, generator=g)
    idx = torch.randint(-50, n_table + 50, (n_gather,), device=cuda_device,
                        generator=g, dtype=torch.int32)
    n0 = ma.DMA_GATHER_LAUNCHES
    got = ma.dma_gather(idx, table, R, 256, stages=stages,
                        stage_rows=stage_rows)
    assert ma.DMA_GATHER_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ma.dma_gather_torch(idx.clamp(0, n_table - 1),
                                                table, R))


@pytest.mark.parametrize("rows", [1, 8, 37, 2048, 100_003])
def test_cmpex_kernels_match_plain(cuda_device, rows):
    """K21c and K21d each equal their own plain version exactly; they agree
    on the odd lanes only."""
    from libhpc_tpu_torch.bench import microarch as ma

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.rand((rows, 128), device=cuda_device, generator=g)
    n0 = (ma.CMPEX_ROLL_LAUNCHES, ma.CMPEX_RESHAPE_LAUNCHES)
    roll, reshape = ma.cmpex_roll(x), ma.cmpex_reshape(x)
    assert (ma.CMPEX_ROLL_LAUNCHES, ma.CMPEX_RESHAPE_LAUNCHES) == (
        n0[0] + 1, n0[1] + 1)
    assert torch.equal(roll, ma.cmpex_roll_torch(x))
    assert torch.equal(reshape, ma.cmpex_reshape_torch(x))
    assert torch.equal(roll[:, 1::2], reshape[:, 1::2])
    assert torch.equal(roll[:, 0], torch.minimum(x[:, 0], x[:, 127]))


def test_microarch_wrappers_raise_on_bad_input(cuda_device):
    from libhpc_tpu_torch.bench import microarch as ma
    from libhpc_tpu_torch.bench import overlap_chip as oc

    x = torch.rand((2048, 128), device=cuda_device)
    idx = torch.zeros((2048, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        oc._sweep_step(x.double(), 1)
    with pytest.raises(ValueError):
        oc._sweep_step(x[:, :64], 1)
    with pytest.raises(TypeError):
        ma.lane_shuffle(x[:8], idx.long())
    with pytest.raises(ValueError):
        ma.lane_shuffle(x[:8], idx.cpu())
    with pytest.raises(TypeError):
        ma.dma_gather(idx[:, 0].contiguous().long(), x, 8, 8)
    with pytest.raises(ValueError):
        ma.dma_gather(idx[:4, 0].contiguous(), x[:, :64], 8, 8)
    with pytest.raises(TypeError):
        ma.cmpex_roll(x.half())
    with pytest.raises(ValueError):
        ma.cmpex_reshape(x.t())


def test_benches_run_on_the_card(cuda_device, capsys):
    """Every microarch bench and the overlap sweep, given no device, run on
    the card through their kernels and emit JSON without an error."""
    import json

    from libhpc_tpu_torch.bench import microarch as ma
    from libhpc_tpu_torch.bench import overlap_chip as oc

    ma.main([])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert {d["bench"] for d in lines} == set(ma.ALL)
    assert all("error" not in d for d in lines), lines
    out = oc.run(mb=64)
    assert out["platform"] == "gpu" and out["stream_gb_per_s"] > 0


# -- the solver family and the other formats (no kernel of their own; the
# AMG V-cycle runs the SBELL SpMV kernel on every level) --------------------

def _amg_launches_per_cycle(H):
    """(fused, near) launches one V-cycle makes: pre - 1 + 1 + post
    matvecs a level, fused on a FarPane (or empty) far set, a near launch
    on FarBlocks."""
    per_level = H.pre - 1 + 1 + H.post
    fused = sum(per_level for lev in H.levels
                if not isinstance(lev.sbell.far, FarBlocks))
    return fused, per_level * len(H.levels) - fused


@pytest.mark.parametrize("name,kw", [
    ("fem", dict(n_levels=3, coarse_max=300)),
    ("poisson64_3lv", dict(n_levels=3, coarse_max=200)),
    ("poisson64_sa", dict(n_levels=2, coarse_max=1500, smooth_p=True))])
def test_amg_vcycle_on_card_matches_cpu(cuda_device, name, kw):
    from libhpc_tpu_torch.examples.amg_solve import spd_fem
    from libhpc_tpu_torch.ops import multigrid_sbell as amg

    A = spd_fem(400) if name == "fem" else matrices.poisson2d(64)
    H_cpu = amg.amg_setup(A, device="cpu", **kw)
    H = amg.amg_setup(A, **kw)
    assert H.device.type == "cuda" and H.levels
    b = np.random.default_rng(3).standard_normal(A.shape[0]) \
        .astype(np.float32)
    want = amg.amg_vcycle(H_cpu, torch.from_numpy(b))
    s0, n0, f0 = _counts()
    got = amg.amg_vcycle(H, torch.from_numpy(b).to(cuda_device))
    torch.cuda.synchronize()
    fused, near = _amg_launches_per_cycle(H)
    assert _counts() == (s0 + fused, n0 + near, f0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    sb = H.levels[0].sbell
    x, it, _ = amg.amg_pcg(H, lambda v: spmv_sbell.sbell_spmv(sb, v), b,
                           tol=1e-6)
    sb_cpu = H_cpu.levels[0].sbell
    _, it_cpu, _ = amg.amg_pcg(H_cpu,
                               lambda v: spmv_sbell.sbell_spmv(sb_cpu, v),
                               torch.from_numpy(b), tol=1e-6)
    assert abs(it - it_cpu) <= 1
    r = b.astype(np.float64) - A @ x.cpu().numpy().astype(np.float64)
    assert np.linalg.norm(r) <= 2e-5 * max(np.linalg.norm(b), 1.0)


def test_amg_guard_panes_stay_zero_over_nan(cuda_device, monkeypatch):
    """Every pane array the V-cycle hands the kernel, and every one it gets
    back, is fresh, contiguous and zero in its guard panes, also where the
    allocator hands out memory that held NaN."""
    from libhpc_tpu_torch.examples.amg_solve import spd_fem
    from libhpc_tpu_torch.ops import multigrid_sbell as amg

    A = spd_fem(400)
    H = amg.amg_setup(A, n_levels=3, coarse_max=300)
    seen = []

    def checked(sb, x3):
        assert x3.is_contiguous() and x3.data_ptr() % 16 == 0
        assert torch.all(x3[sb.n_panes:] == 0)
        out = spmv_sbell.sbell_spmv_panes(sb, x3)
        assert torch.all(out[sb.n_stripes:] == 0)
        assert torch.all(torch.isfinite(out))
        seen.append(sb.n_stripes)
        return out

    monkeypatch.setattr(amg, "sbell_spmv_panes", checked)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.shape[0]).astype(np.float32)).to(cuda_device)
    for _ in range(2):
        junk = torch.full((1 << 22,), float("nan"), device=cuda_device)
        del junk
        u = amg.amg_vcycle(H, b)
        assert torch.all(torch.isfinite(u))
    assert len(seen) == 2 * 4 * len(H.levels)


def test_solver_builders_default_to_the_card(cuda_device):
    from libhpc_tpu_torch.ops import multigrid_sbell as amg
    from libhpc_tpu_torch.sparse import BELL, BSR, COO, BandedHybrid

    A = matrices.poisson2d(40)
    for built in (COO.from_scipy(A), COO.from_dense(A.toarray()),
                  BSR.from_scipy(A), BSR.from_dense(A.toarray()),
                  BELL.from_scipy(A), BandedHybrid.from_scipy(A),
                  amg.amg_setup(A, n_levels=2, coarse_max=500)):
        assert built.device.type == "cuda"


def _format_cases():
    A = sps.random(700, 650, density=0.02, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(9)).tolil()
    A[0, :] = 0
    A[5, :] = 0
    return A.tocsr()


def test_new_spmv_and_spmm_on_card_match_scipy(cuda_device):
    from libhpc_tpu_torch.ops import spmm, spmv
    from libhpc_tpu_torch.sparse import BELL, BSR, COO, CSR, ELL
    from libhpc_tpu_torch.sparse import BandedHybrid

    A = _format_cases()
    m, n = A.shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    Bd = rng.standard_normal((n, 64)).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)

    def gate(got, want):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3,
                                   atol=2e-3)

    gate(spmv.coo_spmv(COO.from_scipy(A), xd), A @ x)
    csr = CSR.from_scipy(A)
    gate(spmv.csr_spmv_t(csr, torch.from_numpy(y).to(cuda_device)), A.T @ y)
    gate(csr @ Bd, A @ Bd)
    gate(spmm.csr_spmm(csr, torch.from_numpy(Bd).to(cuda_device)), A @ Bd)
    gate(spmm.ell_spmm(ELL.from_scipy(A),
                       torch.from_numpy(Bd).to(cuda_device)), A @ Bd)
    bsr = BSR.from_scipy(A, block=8)
    xp = np.zeros(bsr.shape[1], np.float32)
    xp[:n] = x
    gate((bsr @ xp)[:m], A @ x)
    Bp = np.zeros((bsr.shape[1], 64), np.float32)
    Bp[:n] = Bd
    gate(spmm.bsr_spmm(bsr, torch.from_numpy(Bp).to(cuda_device))[:m],
         A @ Bd)
    gate((BELL.from_scipy(A, block=8) @ xp)[:m], A @ x)
    Asq = matrices.poisson2d(48)
    xs = rng.standard_normal(Asq.shape[1]).astype(np.float32)
    gate(BandedHybrid.from_scipy(Asq) @ xs, Asq @ xs)


def test_multigrid_and_precision_on_card_match_cpu(cuda_device):
    from libhpc_tpu_torch.ops import multigrid as mg
    from libhpc_tpu_torch.ops import precision as pr

    rng = np.random.default_rng(0)
    f = rng.random((127, 127)).astype(np.float32)
    h = 1.0 / 128
    u, res = mg.mg_solve(f, h=h, n_cycles=4)
    assert u.device.type == "cuda" and res.device.type == "cuda"
    uc, resc = mg.mg_solve(f, h=h, n_cycles=4, device="cpu")
    torch.testing.assert_close(u.cpu(), uc, rtol=1e-4,
                               atol=1e-4 * float(uc.abs().max()))
    fc = rng.random((128, 128)).astype(np.float32)
    u, res = mg.mg_solve_cc(fc, h=1.0 / 128, n_cycles=4)
    uc, _ = mg.mg_solve_cc(fc, h=1.0 / 128, n_cycles=4, device="cpu")
    torch.testing.assert_close(u.cpu(), uc, rtol=1e-4,
                               atol=1e-4 * float(uc.abs().max()))
    big = rng.random(500_000).astype(np.float32) * 1e7
    x = np.concatenate([big, -big, rng.random(500_001).astype(np.float32)])
    rng.shuffle(x)
    exact = x.astype(np.float64).sum()
    comp = pr.sum_compensated(x)
    assert comp.device.type == "cuda"
    assert abs(float(comp) - exact) < 1e-2
    # eager ops on the card contract nothing: bit-equal to the CPU
    assert float(comp) == float(pr.sum_compensated(x, device="cpu"))
    a = (rng.random(100_001) * 2 - 1).astype(np.float32) * 1e4
    c = (rng.random(100_001) * 2 - 1).astype(np.float32) * 1e-4
    exact = np.dot(a.astype(np.float64), c.astype(np.float64))
    assert abs(float(pr.dot_compensated(a, c)) - exact) \
        <= 1e-6 * abs(exact)


# -- SpGEMM, the integer format products, the utilities (no kernel) ---------

def _spgemm_operands():
    rs = np.random.RandomState(7)
    A = sps.random(300, 260, density=0.04, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(260, 310, density=0.03, format="csr", dtype=np.float32,
                   random_state=rs).tolil()
    B[3, :] = 0
    return A, B.tocsr()


@pytest.mark.parametrize("fn,kw", [("spgemm", {}), ("spgemm_csr", {}),
                                   ("spgemm_blocked", dict(row_block=64)),
                                   ("spgemm_windowed", dict(window=512)),
                                   ("spgemm_windowed", dict(window=512,
                                                            batch=3))])
def test_spgemm_on_card_matches_cpu(cuda_device, fn, kw):
    from libhpc_tpu_torch.ops import spgemm
    from libhpc_tpu_torch.sparse import CSR

    A, B = _spgemm_operands()
    got = getattr(spgemm, fn)(CSR.from_scipy(A), CSR.from_scipy(B), **kw)
    want = getattr(spgemm, fn)(CSR.from_scipy(A, device="cpu"),
                               CSR.from_scipy(B, device="cpu"), **kw)
    assert got.device.type == "cuda"
    dense = got.todense().cpu()
    torch.testing.assert_close(dense, want.todense(), rtol=1e-5,
                               atol=1e-5 * float(dense.abs().max()))
    np.testing.assert_allclose(dense.numpy(), (A @ B).toarray(), rtol=1e-4,
                               atol=1e-4)
    if fn == "spgemm_windowed":            # canonical: the same entries
        assert torch.equal(got.row.cpu(), want.row)
        assert torch.equal(got.col.cpu(), want.col)


@pytest.mark.parametrize("mxu", [True, False])
def test_spgemm_bsr_on_card_matches_cpu(cuda_device, mxu):
    from libhpc_tpu_torch.ops import spgemm_bsr, spmv
    from libhpc_tpu_torch.sparse import BSR

    A = matrices.block_random(60, block=8, blocks_per_row=5, seed=4,
                              far_fraction=0.1)
    got = spgemm_bsr.spgemm_bsr(BSR.from_scipy(A), BSR.from_scipy(A),
                                mxu=mxu, pair_chunk=1000)
    want = spgemm_bsr.spgemm_bsr(BSR.from_scipy(A, device="cpu"),
                                 BSR.from_scipy(A, device="cpu"), mxu=mxu,
                                 pair_chunk=1000)
    assert got.blocks.device.type == "cuda"
    assert torch.equal(got.indices.cpu(), want.indices)
    assert torch.equal(got.indptr.cpu(), want.indptr)
    torch.testing.assert_close(got.blocks.cpu(), want.blocks, rtol=1e-5,
                               atol=1e-5 * float(want.blocks.abs().max()))
    x = np.linspace(-1, 1, A.shape[0]).astype(np.float32)
    y = spmv.bsr_spmv(got, torch.from_numpy(x).to(cuda_device))
    np.testing.assert_allclose(y.cpu().numpy(), A @ (A @ x), rtol=1e-4,
                               atol=1e-4 * np.abs(A @ (A @ x)).max())


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.uint8, np.int64])
def test_integer_format_products_run_on_card(cuda_device, dtype):
    """Integer BSR / BELL / ELL products (and the hybrid's uint32 sum) run
    on the card, where torch has no integer bmm, and equal the CPU's in
    value and dtype."""
    from libhpc_tpu_torch.ops import spmm, spmv
    from libhpc_tpu_torch.sparse import BELL, BSR, ELL, BandedHybrid

    rs = np.random.RandomState(1)
    d = rs.randint(0 if dtype == np.uint8 else -3, 4, (64, 64))
    A = sps.csr_matrix((d * (rs.rand(64, 64) < 0.3)).astype(dtype))
    x = (np.arange(64) % 7).astype(dtype)
    X = np.stack([x, x[::-1]], axis=1)
    calls = {
        "bsr": lambda dev: spmv.bsr_spmv(BSR.from_scipy(A, block=8,
                                                        device=dev),
                                         torch.from_numpy(x).to(dev)),
        "bell": lambda dev: spmv.bell_spmv(BELL.from_scipy(A, block=8,
                                                           device=dev),
                                           torch.from_numpy(x).to(dev)),
        "ell": lambda dev: spmv.ell_spmv(ELL.from_scipy(A, device=dev),
                                         torch.from_numpy(x).to(dev)),
        "hybrid": lambda dev: spmv.hybrid_spmv(
            BandedHybrid.from_scipy(A, max_diags=4, device=dev),
            torch.from_numpy(x).to(dev)),
        "ell_spmm": lambda dev: spmm.ell_spmm(ELL.from_scipy(A, device=dev),
                                              torch.from_numpy(X).to(dev)),
        "bsr_spmm": lambda dev: spmm.bsr_spmm(
            BSR.from_scipy(A, block=8, device=dev),
            torch.from_numpy(X).to(dev)),
    }
    for name, call in calls.items():
        got, want = call(cuda_device), call("cpu")
        assert got.device.type == "cuda", name
        assert got.dtype == want.dtype, name
        assert torch.equal(got.cpu(), want), name
    # a float x into an integer operator: converted, on the card too
    xf = torch.linspace(-2.5, 300.0, 64)
    bsr = BSR.from_scipy(A, block=8, device="cpu")
    assert torch.equal(spmv.bsr_spmv(bsr.to(cuda_device),
                                     xf.to(cuda_device)).cpu(),
                       spmv.bsr_spmv(bsr, xf))


def test_utilities_on_card(cuda_device, tmp_path):
    """The CSR checks reduce on the card; a checkpoint restores onto it."""
    import dataclasses

    from libhpc_tpu_torch.sparse import CSR
    from libhpc_tpu_torch.utils import checkpoint, validate

    csr = CSR.from_scipy(matrices.poisson2d(16))
    err, _ = validate.csr_invariants_checked(csr)
    assert err.get() is None
    bad = dataclasses.replace(csr, indices=csr.indices.clone().fill_(999))
    err, _ = validate.csr_invariants_checked(bad)
    with pytest.raises(ValueError, match="column index out of range"):
        err.throw()
    state = {"x": torch.arange(5.0, device=cuda_device), "csr": csr}
    checkpoint.save(str(tmp_path / "s.npz"), state)
    back = checkpoint.restore(str(tmp_path / "s.npz"), state)
    assert back["x"].device.type == "cuda" and back["csr"].device.type \
        == "cuda"
    assert torch.equal(back["csr"].indices, csr.indices)
