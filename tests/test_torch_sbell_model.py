"""A numpy model of the SBELL SpMV kernel's index arithmetic (CPU).

``csrc/sbell_spmv.cu`` runs only on the card. This model follows its
arithmetic step by step: one CTA a stripe walking its tiles in order, two
threads a slot taking four of the eight j, the two halves added, and the
stripe's far set scattered by ``olane`` in entry order and added last. It
must equal the plain versions (``near_out_panes_torch``,
``far_pane_out_panes_torch``) in f32 and bf16, on stripes of 0, 1, a few
and K_CAP tiles. The model sums in another order than the plain versions:
rtol 1e-5 with an absolute floor of 1e-5 * max|y|.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.ops import far_sbell, spmv_sbell
from libhpc_tpu_torch.sparse.sbell import (B, K_CAP, LANE, W_PANES, SBELL,
                                           FarPane)

JH = B // 2          # j a thread takes


def _far_block(fp, s, x3):
    """far_load + far_gather + far_finish of grouped stripe s: (B, LANE)."""
    E = fp.e_pad
    ep, li = fp.ep.numpy()[s], fp.lidx.numpy()[s]
    olane = fp.olane.numpy()[s]
    bt = fp.bt.float().numpy().reshape(-1, B, B, LANE)[s]   # [j, i, e]
    prod = np.zeros((2, B, LANE), np.float32)                # [h, i, e]
    for e in range(E):
        if ep[e] < 0:
            continue
        for h in range(2):
            g = x3[ep[e], JH * h:JH * h + JH, li[e]]
            pf = bt[JH * h, :, e] * g[0]
            for jj in range(1, JH):
                pf = pf + bt[JH * h + jj, :, e] * g[jj]
            prod[h, :, e] = pf
    out = np.zeros((B, LANE), np.float32)
    for e in range(E):
        if olane[e] >= 0:
            out[:, olane[e]] += prod[0, :, e] + prod[1, :, e]
    return out


def kernel_model(sb, x3, mode):
    """The kernel's output for `mode` (spmv_sbell.MODE_*) as float32 numpy
    ((n_out * B, LANE))."""
    x3 = x3.numpy()
    fp = sb.far
    if mode == spmv_sbell.MODE_FAR:
        return np.concatenate([_far_block(fp, s, x3)
                               for s in range(fp.n_grouped)])
    S = sb.n_stripes
    ptr = sb.tile_ptr.numpy()
    v = sb.vflat.float().numpy().reshape(-1, B, B, LANE)     # [t, j, i, slot]
    meta, pane = sb.meta.numpy(), sb.pane.numpy()
    out = []
    for s in range(S + W_PANES - 1):
        tiles = range(ptr[s], ptr[s + 1]) if s < S else range(0)
        acc = np.zeros((2, B, LANE), np.float32)
        for t in tiles:
            m = meta[t]
            p = pane[t] + (m >> 7)
            for h in range(2):
                g = x3[p, JH * h:JH * h + JH, m & (LANE - 1)].T  # [jj, slot]
                pacc = v[t, JH * h] * g[0]
                for jj in range(1, JH):
                    pacc = pacc + v[t, JH * h + jj] * g[jj]
                acc[h] += pacc
        y = acc[0] + acc[1]
        if mode == spmv_sbell.MODE_BOTH:
            y = y + _far_block(fp, s, x3)
        out.append(y)
    return np.concatenate(out)


def _stripe_depths():
    """Stripes of K_CAP, 0, 1 and 3 tiles and an empty last one; slice 33
    of stripe 0 (64 blocks) goes to the far set."""
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for br in range(128):
        k = 33 if br < 64 else 32
        rows += [br] * k
        cols += list(range(k))
    for br in range(256, 384):
        rows.append(br)
        cols.append(br)
    for br in range(384, 512):
        rows += [br] * 3
        cols += [br - 1, br, br + 1]
    rows, cols = np.array(rows), np.array(cols)
    r = (rows[:, None] * 8 + np.arange(8)).repeat(8, axis=1).ravel()
    c = np.tile(cols[:, None] * 8 + np.arange(8), (1, 8)).ravel()
    vals = rng.standard_normal(r.size).astype(np.float32)
    return sps.coo_matrix((vals, (r, c)), shape=(5 * 1024, 5 * 1024)).tocsr()


MATRICES = {
    "stripe_depths": _stripe_depths,
    "far_split": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.3),
    "block_far": lambda: matrices.block_random(
        260, block=8, blocks_per_row=6, seed=21, half_band=5,
        far_fraction=0.05),
}


def _sbell(name, dtype):
    sb = SBELL.from_scipy(MATRICES[name](), device="cpu")
    return sb if dtype == torch.float32 else sb.astype_values(dtype)


def _x3(sb, seed):
    x = np.random.default_rng(seed).standard_normal(sb.n_panes * 1024)
    return spmv_sbell.x_to_panes(sb, torch.from_numpy(x.astype(np.float32)))


def _close(got, want):
    want = want.numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_stripe_depths_cover_the_cases():
    sb = SBELL.from_scipy(_stripe_depths(), device="cpu")
    assert list(np.diff(sb.tile_ptr.numpy())) == [K_CAP, 0, 1, 3, 0]
    assert sb.k_max == K_CAP
    assert isinstance(sb.far, FarPane) and sb.far.n_far == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_model_near_and_fused(name, dtype):
    sb = _sbell(name, dtype)
    x3 = _x3(sb, seed=1)
    guarded = (sb.n_stripes + W_PANES - 1) * B
    near = spmv_sbell.near_out_panes_torch(sb, x3)
    _close(kernel_model(sb, x3, spmv_sbell.MODE_NEAR), near)
    far = far_sbell.far_pane_out_panes_torch(sb.far, x3, guarded)
    _close(kernel_model(sb, x3, spmv_sbell.MODE_BOTH), near + far)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_model_far_only(name, dtype):
    sb = _sbell(name, dtype)
    x3 = _x3(sb, seed=7)
    fp = sb.far
    got = kernel_model(sb, x3, spmv_sbell.MODE_FAR)
    assert got.shape == (fp.n_grouped * B, LANE)
    _close(got, far_sbell.far_pane_out_panes_torch(fp, x3, fp.n_grouped * B))
