"""Import hygiene of the PyTorch port, and its CPU dispatch rule.

Importing any libhpc_tpu_torch module must pull in no jax, jaxlib or
triton, and must build nothing. On CPU tensors each kernel wrapper runs its
plain version and leaves its launch counter at 0.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
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
    "libhpc_tpu_torch.bench",
    "libhpc_tpu_torch.bench.matrices",
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
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    monkeypatch.setattr(spmv_sbell, "NEAR_LAUNCHES", 0)
    monkeypatch.setattr(far_sbell, "FAR_LAUNCHES", 0)
    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=9,
                              half_band=5, far_fraction=0.05)
    sb = SBELL.from_scipy(A)
    assert isinstance(sb.far, FarPane)
    xpad = np.linspace(-1, 1, sb.n_panes * 1024).astype(np.float32)
    x3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(xpad))
    guarded = (sb.n_stripes + W_PANES - 1) * B
    near = spmv_sbell.near_out_panes(sb, x3)
    assert torch.equal(near, spmv_sbell.near_out_panes_torch(sb, x3))
    far = far_sbell.far_pane_out_panes(sb.far, x3, guarded)
    assert torch.equal(far, far_sbell.far_pane_out_panes_torch(sb.far, x3,
                                                               guarded))
    spmv_sbell.sbell_spmv(sb, torch.from_numpy(xpad[:A.shape[1]]))
    assert spmv_sbell.NEAR_LAUNCHES == 0
    assert far_sbell.FAR_LAUNCHES == 0


def test_cpu_tensors_take_the_plain_path_spmv_family(monkeypatch):
    """K4-K7's wrappers on CPU tensors equal their plain versions and
    leave their launch counters at 0."""
    for mod, name in ((spmv_dia, "DIA_LAUNCHES"), (spmv_dia, "PROBE_LAUNCHES"),
                      (spmv_sell, "SELL_LAUNCHES"), (sellp, "SELLP_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    A = matrices.poisson2d(64)
    x = torch.from_numpy(np.linspace(-1, 1, A.shape[1]).astype(np.float32))
    dp = DIA.from_scipy(A).to_pallas(T=1 << 12)
    x_ext = spmv_dia.extend_x(dp, x)
    assert torch.equal(spmv_dia.dia_out(dp, x_ext),
                       spmv_dia.dia_out_torch(dp, x_ext))
    assert torch.equal(spmv_dia.dia_probe_out(dp, x_ext),
                       spmv_dia.dia_probe_out_torch(dp, x_ext))
    sp = spmv_sell.sell_from_scipy(A)
    x3 = spmv_sell.x_panes(x, sp.n_panes, sp.W - 1)
    assert torch.equal(spmv_sell.sell_out_panes(sp, x3),
                       spmv_sell.sell_out_panes_torch(sp, x3))
    spp = sellp.sellp_from_scipy(A)
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
