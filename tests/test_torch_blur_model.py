"""A numpy model of K19's loops (libhpc_tpu_torch/csrc/blur2d.cu), held
bit for bit against the plain version blur2d_pallas_torch (CPU, no JAX).

The kernel cannot run here, so this model walks its index arithmetic as
the CUDA source does: blocks of TN columns (strips shifted so that a box
starts on a 16-byte boundary) x band_rows rows, stages of S
zero-filled input rows, the x pass's runs of RX sums (head, middle, tail
for a runtime r; every term unrolled for a fixed one), the circular buffer
of 2r + 2S x-sum rows and its row wrap, and the y pass's runs of RY
outputs. Rows of the buffer that no x pass wrote hold NaN, so an output
that read one would differ. Lanes are numpy columns; each accumulator is a
float32 array updated term by term, so the order of adds is the kernel's.
"""

import numpy as np
import pytest
import torch

from libhpc_tpu_torch.ops import stencil

TN, S, RX, RY = 128, 32, 4, 8
FIXED = (0, 1, 2, 3, 8)       # radii with an unrolled instance


def term(acc, k, v, d):
    acc[k] = v.copy() if d == 0 else acc[k] + v


def x_sums(box, r, fixed):
    """(S, TN) x-sums of a stage box (S, box_w): lane l's run starts at
    word 4 l."""
    box_w = box.shape[1]
    nq = (RX + 2 * r + 3) // 4 if fixed else r // 2 + 1 + (r & 1)
    assert 4 * 31 + 4 * nq <= box_w, "a run reads past its box"
    words = [box[:, 4 * np.arange(32) + e] for e in range(4 * nq)]
    acc = [None] * RX
    if fixed:
        for e in range(4 * nq):
            for k in range(RX):
                d = e - k
                if 0 <= d <= 2 * r:
                    term(acc, k, words[e], d)
    else:
        assert r >= 2
        for e in range(4):                       # head
            for k in range(e):
                acc[k] = acc[k] + words[e]
            acc[e] = words[e].copy()
        q_last = r // 2
        for q in range(1, q_last):               # middle
            for s in range(4):
                for k in range(RX):
                    acc[k] = acc[k] + words[4 * q + s]
        base = 4 * q_last
        if r % 2 == 0:
            froms = [(base, 0), (base + 1, 1), (base + 2, 2), (base + 3, 3)]
        else:
            froms = [(base, 0), (base + 1, 0), (base + 2, 0), (base + 3, 1),
                     (base + 4, 2), (base + 5, 3)]
        for e, lo in froms:                      # tail
            for k in range(lo, RX):
                acc[k] = acc[k] + words[e]
    sums = np.empty((S, TN), np.float32)
    for k in range(RX):
        sums[:, k::RX] = acc[k]
    return sums


def y_sums(xb, s0, r, fixed):
    """(RY, TN) outputs from x-sum row s0 of the circular buffer down."""
    rows_b = xb.shape[0]
    p = s0
    read = []

    def next_row():
        nonlocal p
        v = xb[p]
        read.append(p)
        p += 1
        if p == rows_b:
            p = 0
        return v

    acc = [None] * RY
    if fixed:
        for e in range(RY + 2 * r):
            v = next_row()
            for k in range(RY):
                d = e - k
                if 0 <= d <= 2 * r:
                    term(acc, k, v, d)
    else:
        assert r >= 4
        for e in range(RY):
            v = next_row()
            for k in range(e):
                acc[k] = acc[k] + v
            acc[e] = v.copy()
        for _ in range(RY, 2 * r + 1):
            v = next_row()
            for k in range(RY):
                acc[k] = acc[k] + v
        for t in range(1, RY):
            v = next_row()
            for k in range(t, RY):
                acc[k] = acc[k] + v
    assert len(read) == 2 * r + RY
    return np.stack(acc)


def model(a, r, band_rows):
    m, n = a.shape
    fixed = r in FIXED
    box_w = -(-(TN + 2 * r) // 4) * 4
    rows_b = 2 * r + 2 * S
    out = np.full((m, n), np.nan, np.float32)
    delta = (4 - r % 4) % 4          # strips start delta columns left
    strips = -(-(n + delta) // TN)
    bands = -(-m // band_rows)
    for block in range(strips * bands):
        x0 = (block % strips) * TN - delta
        y0 = (block // strips) * band_rows
        rows = min(band_rows, m - y0)
        steps = -(-(rows + 2 * r) // S)
        xb = np.full((rows_b, TN), np.nan, np.float32)
        xs = 0
        for k in range(steps):
            box = np.zeros((S, box_w), np.float32)   # cells outside a: 0
            ys, xc = y0 - r + k * S, x0 - r
            assert xc % 4 == 0, "a TMA box's first column is 16-byte aligned"
            r0, r1 = max(ys, 0), min(ys + S, m)
            c0, c1 = max(xc, 0), min(xc + box_w, n)
            if r0 < r1 and c0 < c1:
                box[r0 - ys:r1 - ys, c0 - xc:c1 - xc] = a[r0:r1, c0:c1]
            sums = x_sums(box, r, fixed)
            for row in range(S):
                xr = xs + row
                if xr >= rows_b:
                    xr -= rows_b
                xb[xr] = sums[row]
            for g in range(S // RY):
                ob = y0 - 2 * r + k * S + RY * g
                if not (ob + RY > y0 and ob < y0 + rows):
                    continue
                s0 = xs + RY * g - 2 * r
                if s0 < 0:
                    s0 += rows_b
                elif s0 >= rows_b:
                    s0 -= rows_b
                acc = y_sums(xb, s0, r, fixed)
                for j in range(RY):
                    o = ob + j
                    if y0 <= o < y0 + rows:
                        c0, c1 = max(x0, 0), min(x0 + TN, n)
                        out[o, c0:c1] = acc[j, c0 - x0:c1 - x0]
            xs += S
            if xs >= rows_b:
                xs -= rows_b
    return out


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 17])
@pytest.mark.parametrize("shape,band_rows", [((70, 150), 64),
                                             ((33, 129), 512),
                                             ((1, 5), 512)])
def test_model_equals_plain_version(rng, shape, band_rows, r):
    a = (rng.random(shape) - 0.5).astype(np.float32)
    want = stencil.blur2d_pallas_torch(torch.from_numpy(a), r).numpy()
    np.testing.assert_array_equal(model(a, r, band_rows), want)


@pytest.mark.parametrize("r", [16, 31, 64])
def test_model_runtime_radius_equals_plain_version(rng, r):
    """The runtime-r form at wide radii, up to the largest, over several
    bands and strips."""
    a = (rng.random((150, 300)) - 0.5).astype(np.float32)
    want = stencil.blur2d_pallas_torch(torch.from_numpy(a), r).numpy()
    np.testing.assert_array_equal(model(a, r, 64), want)
