// symgs_dia.cu — multicoloured Gauss–Seidel sweeps over the DIA planes of a
// 3-D grid operator (HPCG's smoother) for Hopper (sm_90a).
//
// Replaces no TPU kernel: neither package had a Gauss–Seidel sweep. It is
// the smoother of ops/multigrid_dia.py's V-cycle (HPCG's ComputeSYMGS_ref).
// HPCG's lexicographic sweep is serial; here the nx x ny x nz grid is
// coloured by coordinate parity, c = x%2 + 2 (y%2) + 4 (z%2), so that no two
// points of one colour are neighbours under a 27-point stencil, and every
// point of one colour updates at once:
//
//   x[i] = (r[i] - sum_{d != centre} plane[d][i] * x[i + o_d]) / plane[centre][i]
//
// A forward sweep runs colours 7..0, a backward sweep 0..7
// (ops/symgs_dia.py says why colour 0 comes last). The operator is read
// from the arrays K4 (dia.cu) reads, in ops/spmv_dia.py's layout:
// plane[d][row] = dflat[(g D + d) T + k] with row = g T + k, and x lives in
// the level's extended x (x_ext: x at x_pad_lo, zeros around it), so
// x[i + o_d] = x_ext[i + coffs[d]] with no bounds test: a neighbour outside
// the grid has a zero coefficient and reads a zero or a value of another row
// that it multiplies by zero. Such a product adds +0 or -0 to a sum that
// started at +0, which leaves the sum's bits as they were whatever the value
// read, so a race on it cannot change a result.
//
// What bounds it: bytes. A sweep reads each row's D plane values and r, and
// x with its neighbours, and writes x. Two launch forms:
//
//   - symgs_colour_kernel: one colour, one thread a row. Its rows are every
//     other point along x, so each warp load of a plane or of r uses half of
//     every 32-byte sector it fetches, and the other half is fetched again
//     by the launch of the other x-parity colour: the planes are 50 times L2
//     at 256^3, so nothing survives between the two launches. 8 such
//     launches fetch the planes about twice. Reads of x go through the
//     read-only path (__ldg): no point a launch writes is read by it.
//   - symgs_pair_kernel: the colours c and c ^ 1 (same y and z parity) in one
//     launch, in the order given. Of the colours a sweep has run before the
//     pair's second colour, the pair's first colour is the only one whose
//     values the second reads, and it reads them only at x +- 1 on its own
//     x-line: every other neighbour differs in y or z parity. So a CTA owns
//     whole x-lines of the pair's (y, z) parity, updates the first colour's
//     points, passes a __syncthreads(), and updates the second's; no CTA
//     reads what another writes (but for the zero products above). A thread
//     owns four consecutive points of a line, two of each colour, as K4's
//     threads own four rows: its plane and r loads are 16 bytes wide (where
//     the row's alignment and tile allow; 4-byte loads otherwise), so a warp
//     uses whole sectors and each sector comes from HBM once. A CTA holds at
//     most 128 threads, as many lines as fit: at 256^3 a pair launch has
//     8,192 CTAs, at 32^3 16. 4 launches a sweep, each moving a
//     quarter of the least bytes (hpcbench/roofline_mg.py: each plane value,
//     r and x read once, x written once) and x's neighbour lines once.
//
// Why a pair is bit-equal to its two colours launched one at a time: each
// row's sum is the same float32 FMAs in the same order, acc = fma(plane[d],
// x[row + o_d], acc) over d = 0..D-1 skipping the centre, then (r - acc) /
// centre, on the same x values. The first colour reads x before any of the
// pair's writes, as its own launch would. The second colour sums, before
// the barrier, the diagonals ahead of the first that can read the line
// (offset +-1: split), and keeps the plane values of the rest in shared
// memory, not left to L1; after the barrier it adds them in order, reading
// the first colour's new values. In a pair launch x is read by plain loads
// only, never the non-coherent path: a sector cached for the first colour
// holds second-colour entries and the reverse, and __syncthreads() orders
// the CTA's writes before its reads.
//
// coffs (at most 96 ints) travels by value in the kernel's parameters;
// index arithmetic is 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 96;  // ops/spmv.py MAX_DIA_OFFSETS
constexpr int kThreads = 256;
// a pair launch: kPts points a thread along x, at most kPairThreads
// threads a CTA, a whole line in one CTA
constexpr int kPts = 4;
constexpr int kPairThreads = 128;
constexpr int kMaxPairNx = kPts * kPairThreads;  // ops/symgs_dia.py MAX_PAIR_NX

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
    acc = fmaf(__ldg(plane + d * T), __ldg(x_in + row + co.c[d]), acc);
  }
  x_out[x_pad_lo + row] = (__ldg(r + row) - acc) / __ldg(plane + centre * T);
}

template <int kBytes>
__device__ __forceinline__ bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0;
}

// A thread's points x0 + p, p < kPts, of one line: row0 is x0's row and
// pa its plane value on diagonal 0. Points p < live lie on the line, and
// points p < near in pa's tile (the rest in the next one, jump floats
// further on). A point off the line reads the thread's first point (a
// thread with no line reads row 0) and writes nothing. VEC: live == kPts
// == near, and pa and r + row0 16-byte aligned.
struct Pts {
  int64_t row0;
  const float* pa;
  int64_t jump;
  int live, near;

  __device__ __forceinline__ int64_t row(int p) const {
    return row0 + (p < live ? p : 0);
  }
  __device__ __forceinline__ const float* plane(int p) const {
    return pa + (p >= live ? 0 : p < near ? p : p + jump);
  }
};

// The points' plane values on diagonal d (dT = d T), and x at their rows
// + o.
template <bool VEC>
__device__ __forceinline__ void load_planes(const Pts& pt, int64_t dT,
                                            float* a) {
  if (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(pt.pa + dT));
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else {
#pragma unroll
    for (int p = 0; p < kPts; ++p) a[p] = __ldg(pt.plane(p) + dT);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_x(const float* x, const Pts& pt, int o,
                                       float* v) {
  const float* xp = x + pt.row0 + o;
  if (VEC && aligned<16>(xp)) {
    const float4 w = *reinterpret_cast<const float4*>(xp);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else if (VEC && aligned<8>(xp)) {
    const float2 lo = *reinterpret_cast<const float2*>(xp);
    const float2 hi = *reinterpret_cast<const float2*>(xp + 2);
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
#pragma unroll
    for (int p = 0; p < kPts; ++p) v[p] = x[pt.row(p) + o];
  }
}

// The pair kernel up to its barrier: every point's sum over the diagonals
// ahead of split; from split on the first colour's sums (points PF and
// PF + 2), and the second colour's plane values into the thread's stash;
// the points' r.
template <bool VEC, int PF>
__device__ __forceinline__ void pair_first(const Pts& pt, const float* x,
                                           const float* r, const Coffs& co,
                                           int D, int centre, int split,
                                           int64_t T, float* acc, float* diag,
                                           float* rv, float2* stash, int nt) {
#pragma unroll 4
  for (int d = 0; d < split; ++d) {
    float a[kPts], v[kPts];
    load_planes<VEC>(pt, d * T, a);
    if (d == centre) {
#pragma unroll
      for (int p = 0; p < kPts; ++p) diag[p] = a[p];
      continue;
    }
    load_x<VEC>(x, pt, co.c[d], v);
#pragma unroll
    for (int p = 0; p < kPts; ++p) acc[p] = fmaf(a[p], v[p], acc[p]);
  }
#pragma unroll 4
  for (int d = split; d < D; ++d) {
    float a[kPts];
    load_planes<VEC>(pt, d * T, a);
    if (d == centre) {
#pragma unroll
      for (int p = 0; p < kPts; ++p) diag[p] = a[p];
      continue;
    }
    acc[PF] = fmaf(a[PF], x[pt.row(PF) + co.c[d]], acc[PF]);
    acc[PF + 2] = fmaf(a[PF + 2], x[pt.row(PF + 2) + co.c[d]], acc[PF + 2]);
    stash[(d - split) * nt] = make_float2(a[1 - PF], a[3 - PF]);
  }
  if (VEC) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(r + pt.row0));
    rv[0] = w.x, rv[1] = w.y, rv[2] = w.z, rv[3] = w.w;
  } else {
#pragma unroll
    for (int p = 0; p < kPts; ++p) rv[p] = __ldg(r + pt.row(p));
  }
}

// The pair of colours (PF + 2 cy + 4 cz, its x ^ 1), PF's first. The block
// is lines * tpl threads, tpl = ceil(nx / kPts) a line; thread t of a line
// owns its points x = kPts t + p, p < kPts (fewer at the end of a line): p
// even or odd as x. Shared memory: a float2 a diagonal from split on, the
// plane values of the thread's two second-colour points.
template <int PF>
__global__ void __launch_bounds__(kPairThreads)
    symgs_pair_kernel(const float* __restrict__ dflat, float* x,
                      const float* __restrict__ r, Coffs co, int D,
                      int centre, int split, int64_t T, int64_t x_pad_lo,
                      int64_t nx, int64_t ny, int64_t hy, int cy, int cz,
                      int64_t n_lines, int tpl) {
  extern __shared__ float2 stash[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t line =
      static_cast<int64_t>(blockIdx.x) * (nt / tpl) + tid / tpl;
  const int64_t x0 = kPts * static_cast<int64_t>(tid % tpl);
  const bool on = line < n_lines;
  const int64_t j = line % hy, k = line / hy;
  Pts pt;
  pt.row0 = on ? ((2 * k + cz) * ny + (2 * j + cy)) * nx + x0 : 0;
  pt.live = !on ? 0 : nx - x0 < kPts ? static_cast<int>(nx - x0) : kPts;
  const int64_t g = pt.row0 / T, i = pt.row0 - g * T;
  pt.pa = dflat + g * D * T + i;
  pt.near = T - i < kPts ? static_cast<int>(T - i) : kPts;
  pt.jump = (D - 1) * T;
  float acc[kPts] = {}, diag[kPts], rv[kPts];
  if (pt.live == kPts && pt.near == kPts && aligned<16>(pt.pa) &&
      aligned<16>(r + pt.row0))
    pair_first<true, PF>(pt, x, r, co, D, centre, split, T, acc, diag, rv,
                         stash + tid, nt);
  else
    pair_first<false, PF>(pt, x, r, co, D, centre, split, T, acc, diag, rv,
                          stash + tid, nt);
  if (PF < pt.live)
    x[x_pad_lo + pt.row(PF)] = (rv[PF] - acc[PF]) / diag[PF];
  if (PF + 2 < pt.live)
    x[x_pad_lo + pt.row(PF + 2)] = (rv[PF + 2] - acc[PF + 2]) / diag[PF + 2];
  __syncthreads();
  constexpr int s0 = 1 - PF, s1 = 3 - PF;
  if (s0 >= pt.live) return;
#pragma unroll 4
  for (int d = split; d < D; ++d) {
    if (d == centre) continue;
    const float2 a = stash[(d - split) * nt + tid];
    acc[s0] = fmaf(a.x, x[pt.row(s0) + co.c[d]], acc[s0]);
    acc[s1] = fmaf(a.y, x[pt.row(s1) + co.c[d]], acc[s1]);
  }
  x[x_pad_lo + pt.row(s0)] = (rv[s0] - acc[s0]) / diag[s0];
  if (s1 < pt.live)
    x[x_pad_lo + pt.row(s1)] = (rv[s1] - acc[s1]) / diag[s1];
}

// Raise a pair instance's dynamic shared memory limit to the most a launch
// asks (kMaxD float2 a thread), once an instance and device.
template <int PF>
cudaError_t allow_smem() {
  static uint64_t raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (raised >> dev & 1))) return e;
  e = cudaFuncSetAttribute(
      symgs_pair_kernel<PF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxD * kPairThreads * static_cast<int>(sizeof(float2)));
  if (e == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  return e;
}

}  // namespace

// Run the launches launches[0..n_launches) in turn, each a pair of ints:
// (colour, -1) launches that colour alone, (c, c ^ 1) the pair, c first (a
// launch with no rows launches nothing). coffs (D ints) and launches are
// HOST arrays.
extern "C" int symgs_dia_f32(const void* dflat, void* x_ext, const void* r,
                             const void* coffs, const void* launches, int D,
                             int T, int centre, int x_pad_lo, int nx, int ny,
                             int nz, int n_launches, void* stream) {
  if (D < 1 || D > kMaxD || centre < 0 || centre >= D || T <= 0 ||
      nx <= 0 || ny <= 0 || nz <= 0 || n_launches < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Coffs co = {};
  const int* c = static_cast<const int*>(coffs);
  for (int d = 0; d < D; ++d) co.c[d] = c[d];
  // the first diagonal that reads a neighbour along x
  int split = D;
  for (int d = D - 1; d >= 0; --d)
    if (c[d] - x_pad_lo == 1 || c[d] - x_pad_lo == -1) split = d;
  const int* ls = static_cast<const int*>(launches);
  float* x = static_cast<float*>(x_ext);
  const float* planes = static_cast<const float*>(dflat);
  const float* rhs = static_cast<const float*>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int n = 0; n < n_launches; ++n) {
    const int colour = ls[2 * n], second = ls[2 * n + 1];
    if (colour < 0 || colour > 7 ||
        (second != -1 && (second != (colour ^ 1) || nx > kMaxPairNx)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int cx = colour & 1, cy = (colour >> 1) & 1, cz = (colour >> 2) & 1;
    const int64_t hx = (nx - cx + 1) / 2, hy = (ny - cy + 1) / 2,
                  hz = (nz - cz + 1) / 2;
    if (second == -1) {
      const int64_t rows = hx * hy * hz;
      if (rows == 0) continue;
      const int64_t blocks = (rows + kThreads - 1) / kThreads;
      symgs_colour_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          planes, x, x, rhs, co, D, centre, T, x_pad_lo, nx, ny, hx, hy, cx,
          cy, cz, rows);
    } else {
      const int64_t lines = hy * hz;
      if (lines == 0) continue;
      const int tpl = (nx + kPts - 1) / kPts, per_cta = kPairThreads / tpl;
      const int threads = per_cta * tpl;
      const int64_t blocks = (lines + per_cta - 1) / per_cta;
      const size_t smem = sizeof(float2) * (D - split) * threads;
      cudaError_t e = cudaSuccess;
      if (smem > 48 * 1024) e = cx ? allow_smem<1>() : allow_smem<0>();
      if (e != cudaSuccess) return static_cast<int>(e);
      if (cx)
        symgs_pair_kernel<1><<<static_cast<unsigned>(blocks), threads, smem,
                               s>>>(planes, x, rhs, co, D, centre, split, T,
                                    x_pad_lo, nx, ny, hy, cy, cz, lines, tpl);
      else
        symgs_pair_kernel<0><<<static_cast<unsigned>(blocks), threads, smem,
                               s>>>(planes, x, rhs, co, D, centre, split, T,
                                    x_pad_lo, nx, ny, hy, cy, cz, lines, tpl);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
