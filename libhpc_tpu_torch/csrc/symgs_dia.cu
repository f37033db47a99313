// symgs_dia.cu — one colour of a multicoloured Gauss–Seidel sweep over the
// DIA planes of a 3-D grid operator (HPCG's smoother) for Hopper (sm_90a).
//
// Replaces no TPU kernel: neither package had a Gauss–Seidel sweep. It is
// the smoother of ops/multigrid_dia.py's V-cycle (HPCG's ComputeSYMGS_ref).
// HPCG's lexicographic sweep is serial; here the nx x ny x nz grid is
// coloured by coordinate parity, c = x%2 + 2 (y%2) + 4 (z%2), so that no two
// points of one colour are neighbours under a 27-point stencil, and one
// launch updates every point of one colour at once:
//
//   x[i] = (r[i] - sum_{d != centre} plane[d][i] * x[i + o_d]) / plane[centre][i]
//
// for the rows i of that colour. A forward sweep launches colours 7..0, a
// backward sweep 0..7 (ops/symgs_dia.py says why colour 0 comes last). The operator is read from the arrays K4 (dia.cu)
// reads, in ops/spmv_dia.py's layout: plane[d][row] = dflat[(g D + d) T + k]
// with row = g T + k, and x lives in the level's extended x (x_ext: x at
// x_pad_lo, zeros around it), so x[i + o_d] = x_ext[i + coffs[d]] with no
// bounds test: a neighbour outside the grid has a zero coefficient and
// reads a zero or a value of another row that it multiplies by zero.
//
// Design:
//   - One thread a row of the colour; neighbouring threads take rows two
//     apart along x. No point a launch writes is read by the same launch
//     (the centre is skipped, every neighbour has another colour), so the
//     reads of x go through the read-only path (__ldg).
//   - The neighbour sum runs in diagonal order, skipping the centre, in
//     float32 multiply-adds; the plain version (ops/symgs_dia.py:
//     sweep_torch) sums in another order.
//   - coffs (at most 96 ints) travels by value in the kernel's parameters;
//     index arithmetic is 64-bit.
//
// What bounds it: bytes. A colour reads its rows' D plane values, r, and x
// with its neighbours, and writes x. Its rows are every other entry of a
// plane along x, so a warp's loads touch whole 32-byte sectors of which it
// uses half: a sweep of 8 colours fetches the planes about twice. The
// least bytes of a sweep (hpcbench/roofline_mg.py) count each plane value,
// r and x read once and x written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 96;  // ops/spmv.py MAX_DIA_OFFSETS
constexpr int kThreads = 256;

struct Coffs {
  int c[kMaxD];
};

__global__ void __launch_bounds__(kThreads)
    symgs_colour_kernel(const float* __restrict__ dflat,
                        const float* __restrict__ x_in, float* x_out,
                        const float* __restrict__ r, Coffs co, int D,
                        int centre, int64_t T, int64_t x_pad_lo, int64_t nx,
                        int64_t ny, int64_t hx, int64_t hy, int cx, int cy,
                        int cz, int64_t n_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_rows) return;
  const int64_t i = t % hx;
  const int64_t rest = t / hx;
  const int64_t j = rest % hy;
  const int64_t k = rest / hy;
  const int64_t row = ((2 * k + cz) * ny + (2 * j + cy)) * nx + (2 * i + cx);
  const int64_t g = row / T;
  const float* plane = dflat + g * D * T + (row - g * T);

  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    if (d == centre) continue;
    const float a = __ldg(plane + d * T);
    acc += a * __ldg(x_in + row + co.c[d]);
  }
  x_out[x_pad_lo + row] = (__ldg(r + row) - acc) / __ldg(plane + centre * T);
}

}  // namespace

// Update the colours colours[0..n_colours) of the nx x ny x nz grid in turn,
// one launch each (a colour with no rows launches nothing). coffs (D ints)
// and colours are HOST arrays.
extern "C" int symgs_dia_f32(const void* dflat, void* x_ext, const void* r,
                             const void* coffs, const void* colours, int D,
                             int T, int centre, int x_pad_lo, int nx, int ny,
                             int nz, int n_colours, void* stream) {
  if (D < 1 || D > kMaxD || centre < 0 || centre >= D || T <= 0 ||
      nx <= 0 || ny <= 0 || nz <= 0 || n_colours < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Coffs co = {};
  const int* c = static_cast<const int*>(coffs);
  for (int d = 0; d < D; ++d) co.c[d] = c[d];
  const int* cols = static_cast<const int*>(colours);
  float* x = static_cast<float*>(x_ext);
  for (int n = 0; n < n_colours; ++n) {
    const int colour = cols[n];
    if (colour < 0 || colour > 7)
      return static_cast<int>(cudaErrorInvalidValue);
    const int cx = colour & 1, cy = (colour >> 1) & 1, cz = (colour >> 2) & 1;
    const int64_t hx = (nx - cx + 1) / 2, hy = (ny - cy + 1) / 2,
                  hz = (nz - cz + 1) / 2;
    const int64_t rows = hx * hy * hz;
    if (rows == 0) continue;
    const int64_t blocks = (rows + kThreads - 1) / kThreads;
    symgs_colour_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dflat), x, x, static_cast<const float*>(r),
        co, D, centre, T, x_pad_lo, nx, ny, hx, hy, cx, cy, cz, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
