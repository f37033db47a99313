"""The port's far-set products against libhpc_tpu (CPU).

``far_pane_out_panes_torch`` (the plain version of the far kernel) must
equal the reference's Pallas far kernel (interpret mode) and its XLA form
at rtol 1e-5, atol 1e-6 (tests/test_far_pallas.py:57-63); the FarBlocks
``far_spmv`` must equal the reference's.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import far_pallas as ref_far
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.ops import spmv_pallas as ref_sbell_spmv
from libhpc_tpu.sparse.sbell import SBELL as RefSBELL
from libhpc_tpu_torch.ops import far_sbell, spmv, spmv_sbell
from libhpc_tpu_torch.sparse.sbell import B, W_PANES, FarBlocks, FarPane
from libhpc_tpu_torch.sparse.sbell import SBELL

from _torch_port import port_of


def _x3(sb, n):
    x = np.linspace(-1, 1, n).astype(np.float32)
    xpad = np.pad(x, (0, sb.n_panes * 1024 - n))
    return x, xpad


def _far_parity(A, dtype=None):
    """Reference far kernel, reference XLA form and the port's plain
    version on one guarded pane vector; returns the port's SBELL."""
    ref = RefSBELL.from_scipy(A)
    port = port_of(ref)
    if dtype is not None:
        ref = ref.astype_values(jnp.bfloat16)
        port = port.astype_values(dtype)
    assert isinstance(port.far, FarPane)
    x, xpad = _x3(port, A.shape[1])
    guarded = (port.n_stripes + W_PANES - 1) * B
    r3 = ref_sbell_spmv.x_to_panes(ref, jnp.asarray(xpad))
    got = far_sbell.far_pane_out_panes_torch(
        port.far, spmv_sbell.x_to_panes(port, torch.from_numpy(xpad)),
        guarded).numpy()
    assert got.shape == (guarded, 128)
    assert np.all(got[port.n_stripes * B:] == 0.0)
    want_k = np.asarray(ref_far.far_pane_out_panes(ref.far, r3, guarded))
    want_x = np.asarray(ref_far.far_pane_out_panes_xla(ref.far, r3, guarded))
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_x, rtol=1e-5, atol=1e-6)
    return port, x


@pytest.mark.parametrize("seed", [21, 5])
def test_far_pane_matches_reference(seed):
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=seed,
                              half_band=5, far_fraction=0.05)
    _far_parity(A)


def _one_stripe_spread(n_panes):
    """One stripe whose 128 block-rows each hold one block, spread over
    n_panes panes: the slice keeps 3 panes, the rest go to the far set."""
    k = np.arange(128, dtype=np.int64)
    bcols = (k % n_panes) * 128 + (k * 7) % 128
    return sps.coo_matrix(
        (np.linspace(1, 2, 128, dtype=np.float32), (k * 8, bcols * 8)),
        shape=(1024, n_panes * 1024)).tocsr()


def test_far_pane_multi_pane_stripe():
    """The reference's multi-pane stripe (tests/test_far_pallas.py:66-79)."""
    rows = np.arange(128, dtype=np.int64) * 8
    cols = (np.arange(128, dtype=np.int64) * 977) % 2000
    A = sps.coo_matrix((np.linspace(1, 2, 128, dtype=np.float32),
                        (rows, cols * 8)), shape=(1024, 2048 * 8)).tocsr()
    port, x = _far_parity(A)
    assert port.far.d_max > 1
    y = spmv_sbell.sbell_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-4)


def test_far_pane_wide_spread_stripe():
    """A stripe whose far entries span more than 20 distinct panes: the
    FarPane builder puts no bound on d_max (pwtk_like reaches 27)."""
    A = _one_stripe_spread(32)
    port, x = _far_parity(A)
    assert port.far.d_max > 20
    y = spmv_sbell.sbell_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-4)


def test_far_pane_bf16():
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=9,
                              half_band=5, far_fraction=0.05)
    port, _ = _far_parity(A, torch.bfloat16)
    assert port.far.bt.dtype == torch.bfloat16
    assert port.far.oh.dtype == torch.float32


def _check_olane(fp):
    """olane holds, for every entry, the lane of the one 1 in its row of
    oh, and -1 for an empty row and past e_pad."""
    S, E = fp.n_grouped, fp.e_pad
    oh = fp.oh.reshape(S, E, -1).numpy()
    olane = fp.olane.numpy()
    assert fp.olane.dtype == torch.int32 and olane.shape == (S, 128)
    assert np.all(olane[:, E:] == -1)
    ones = oh.sum(axis=2)
    assert np.all((ones == 0) | (ones == 1))
    assert np.array_equal(olane[:, :E] >= 0, ones == 1)
    assert np.array_equal(olane[:, :E] >= 0, fp.ep.numpy()[:, :E] >= 0)
    s_i, e_i = np.nonzero(ones)
    assert np.all(oh[s_i, e_i, olane[s_i, e_i]] == 1.0)


FAR_MATRICES = {
    "block_random21": lambda: matrices.block_random(
        260, block=8, blocks_per_row=6, seed=21, half_band=5,
        far_fraction=0.05),
    "block_random5": lambda: matrices.block_random(
        260, block=8, blocks_per_row=6, seed=5, half_band=5,
        far_fraction=0.05),
    "multi_pane": lambda: sps.coo_matrix(
        (np.linspace(1, 2, 128, dtype=np.float32),
         (np.arange(128) * 8, ((np.arange(128) * 977) % 2000) * 8)),
        shape=(1024, 2048 * 8)).tocsr(),
    "wide_spread": lambda: _one_stripe_spread(32),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", sorted(FAR_MATRICES))
def test_far_pane_olane(name, bf16):
    """The derived output lanes the Hopper kernel reads in place of the
    one-hot plane: built from oh, equal whether the container comes from
    the port's builder or from the reference's leaves, carried through
    astype_values and to(), and left out of the reference's leaves."""
    A = FAR_MATRICES[name]()
    ref = RefSBELL.from_scipy(A)
    port = SBELL.from_scipy(A, device="cpu")
    assert isinstance(port.far, FarPane)
    _check_olane(port.far)
    assert torch.equal(port_of(ref).far.olane, port.far.olane)
    assert "olane" not in port.far.to_numpy()
    if bf16:
        q = port.astype_values(torch.bfloat16).to("cpu")
        assert q.far.olane is port.far.olane
        _check_olane(q.far)


@pytest.mark.parametrize("bf16", [False, True])
def test_far_blocks_far_spmv(bf16):
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=21,
                              half_band=5, far_fraction=0.05)
    ref = RefSBELL.from_scipy(A, group_far=False)
    if bf16:
        ref = ref.astype_values(jnp.bfloat16)
    port = port_of(ref)
    assert isinstance(port.far, FarBlocks)
    x = np.random.default_rng(4).standard_normal(ref.far.shape[1]) \
        .astype(np.float32)
    got = spmv.far_spmv(port.far, torch.from_numpy(x)).numpy()
    want = np.asarray(ref_spmv.far_spmv(ref.far, jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
