// blur2d.cu — 2-D box sum with a zero halo for Hopper (sm_90a), K19.
//
// Replaces the TPU kernel libhpc_tpu/ops/stencil.py:_blur2d_kernel
// (blur2d_pallas):
//
//   out[y, x] = sum_{dy=-r..r} sum_{dx=-r..r} a[y+dy, x+dx],
//   cells outside a read as zero; a, out: (M, N) float32 row-major
//
// Both passes are direct sums in a fixed order: along x the 2r + 1 terms
// from left to right, then along y the 2r + 1 x-sums from top to bottom,
// each sum started from its first term. The plain version
// (ops/stencil.py:blur2d_pallas_torch) adds the same terms in the same
// order, so the two agree bit for bit (up to the sign of a zero sum).
//
// What bounds it: the bytes of a read once and of out written once (8 B an
// output; 0.160 ms at 8192^2 on an H100 SXM). The adds, 2 (2r + 1) an
// output, stay under that bound up to r = 8 or so and bound it beyond.
// The design keeps shared-memory traffic and instructions small enough to
// hide under the memory stream:
//
//   - A block owns a strip of TN = 128 output columns and a band of
//     `band_rows` rows (the plan's: 256 up to r = 8, 1024 beyond), and walks down the band in
//     stages of S = 32 input rows. A 1-D grid, strips fastest (blocks of
//     neighbouring strips share their x halo in the L2), so nothing caps M.
//     Strips start (-r mod 4) columns left of a multiple of TN, so that a
//     box's first column is a multiple of 4: a TMA copy whose innermost
//     coordinate is not 16-byte aligned faults (an illegal-instruction
//     error on an H100).
//   - Each stage is one box of S rows x box_w >= TN + 2r columns (a
//     multiple of 4 floats, at most 256) of a, with its top-left cell at
//     (x0 - r, y): a ring of NST = 3 stages, so that two stages are in
//     flight while one is summed.
//       MODE_TMA: one thread issues a 2-D TMA copy of the box from a tensor
//       map of a; the hardware writes zeros for every cell outside a, and
//       the stage's mbarrier (hopper_async.cuh) reports its bytes. Needs a
//       16-byte-aligned a and N % 4 == 0 (the map's row stride).
//       MODE_PLAIN: every thread issues 4-byte cp.async copies of its cells,
//       coalesced along the rows; src-size 0 writes the zeros outside a.
//     The wrapper picks the mode (ops/stencil.py:blur_plan).
//   - x pass, register-blocked: a thread sums a run of RX = 4 adjacent
//     x-sums of one stage row. It reads the run's 4 + 2r window words once,
//     as 16-byte loads (a warp's lanes read adjacent 16-byte words:
//     conflict-free at any row pitch), and adds each word into every
//     accumulator of the run it belongs to. For runtime r the terms split
//     into a head (words 0..3), a middle that every accumulator takes
//     (words 4..2r-1, a loop) and a tail (words 2r..2r+3, accumulator k
//     from word 2r + k on): no predicate and no wasted add. The x-sums go
//     to a circular buffer of 2r + 2S rows of TN floats.
//   - y pass, register-blocked: a thread sums RY = 8 outputs down a column
//     pair, reading the 2r + 8 x-sum rows once as 8-byte loads, split as
//     in the x pass (head rows 0..7, middle 8..2r, tail). The buffer holds
//     2r + 2S rows, so the x pass of stage k + 1 writes rows that the
//     y pass of stage k does not read: one __syncthreads() a stage (two in
//     MODE_PLAIN, where the copies need one too).
//   - Stores: each warp writes 256 contiguous bytes of a row (8-byte
//     stores, evict-first).
//   - Shared-memory words an output at r = 8: the box 1.13, x-pass reads
//     5 and stores 1, y-pass reads 3: about 10, so the shared-memory pipe
//     stays well under the memory stream's time.
//   - Instances: r = 0..3 (the runtime split needs r >= 4) and r = 8 (the
//     main path's radius) are fully unrolled templates; any other r in
//     4..64 runs the runtime form.
//
// Shared memory: NST * S * box_w floats of ring + (2r + 2S) * TN floats of
// x-sums + NST mbarriers + 128 bytes of alignment: 96,408 B at r = 8 (two
// blocks an SM), 196,760 B at r = 64 (one).

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "hopper_async.cuh"

namespace {

constexpr int TN = 128;        // output columns a block
constexpr int S = 32;          // input rows a stage
constexpr int NST = 3;         // stages in the ring
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RX = 4;          // x-sums a thread's run (one 16-byte word)
constexpr int RY = 8;          // outputs a thread's run down a column pair
constexpr int MAX_RADIUS = 64;
constexpr int MAX_BOX = 256;   // a TMA box dimension
constexpr int MAX_SMEM = 232448;
constexpr int MODE_TMA = 0;
constexpr int MODE_PLAIN = 1;

static_assert(TN == 32 * RX, "x pass: a warp's runs cover the strip");
static_assert((THREADS / 64) * RY == S,
              "y pass: 64 column pairs x (S / RY) row groups");
static_assert(S % WARPS == 0, "x pass: whole rows a warp");
static_assert(NST >= 2, "a ring of one stage would overwrite the stage read");

// columns the strips start left of a multiple of TN: x0 - r is then a
// multiple of 4
__host__ __device__ __forceinline__ int strip_shift(int r) {
  return (4 - r % 4) % 4;
}

// columns of a stage's box: TN + 2r rounded up to 4 floats (a TMA box's
// row is a multiple of 16 bytes)
constexpr int box_width(int r) { return (TN + 2 * r + 3) / 4 * 4; }

constexpr int smem_bytes(int r, int box_w) {
  return 128 + NST * S * box_w * 4 + (2 * r + 2 * S) * TN * 4 + NST * 8;
}

// both grow with r: the widest radius bounds every launch
static_assert(box_width(MAX_RADIUS) <= MAX_BOX, "a stage's box is a TMA box");
static_assert(smem_bytes(MAX_RADIUS, box_width(MAX_RADIUS)) <= MAX_SMEM,
              "a block's shared memory fits an SM");

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool full) {
  // src-size 0 reads nothing and writes a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

// term d of accumulator k (0 <= d <= 2r); the first one starts the sum
template <typename T>
__device__ __forceinline__ void term(T& acc, T v, int d) {
  if (d == 0) {
    acc = v;
  } else {
    add(acc, v);
  }
}

// acc[k] += v for k in [LO, N)
template <int LO, int N, typename T>
__device__ __forceinline__ void add_from(T (&acc)[N], T v) {
#pragma unroll
  for (int k = LO; k < N; ++k) add(acc[k], v);
}

// the head's term e: acc[k] += v for k < e, and acc[e] starts at v
template <int E, int N, typename T>
__device__ __forceinline__ void head(T (&acc)[N], T v) {
#pragma unroll
  for (int k = 0; k < E; ++k) add(acc[k], v);
  acc[E] = v;
}

// The RX x-sums of a run: w points at the run's first window word (16-byte
// aligned), sum k = w[k] + ... + w[k + 2r], added left to right.
template <int R>
__device__ __forceinline__ float4 x_sums(const float* w, int r) {
  float acc[RX];
  if constexpr (R >= 0) {
    constexpr int WORDS = RX + 2 * R;
#pragma unroll
    for (int q = 0; q < (WORDS + 3) / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(w + 4 * q);
      const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int k = 0; k < RX; ++k) {
          const int d = 4 * q + s - k;
          if (d >= 0 && d <= 2 * R) term(acc[k], e4[s], d);
        }
      }
    }
  } else {
    // r >= 2: words 0..3 are every run's head
    float4 v = *reinterpret_cast<const float4*>(w);
    head<0>(acc, v.x);
    head<1>(acc, v.y);
    head<2>(acc, v.z);
    head<3>(acc, v.w);
    // words 4 .. 2r - 1 go to every accumulator; the chunk holding word 2r
    // is chunk r / 2 (words 2r .. 2r + 3 for r even, 2r - 2 .. 2r + 1 for
    // r odd)
    const int last = r / 2;
#pragma unroll 2
    for (int q = 1; q < last; ++q) {
      v = *reinterpret_cast<const float4*>(w + 4 * q);
      add_from<0>(acc, v.x);
      add_from<0>(acc, v.y);
      add_from<0>(acc, v.z);
      add_from<0>(acc, v.w);
    }
    v = *reinterpret_cast<const float4*>(w + 4 * last);
    if ((r & 1) == 0) {
      add_from<0>(acc, v.x);  // word 2r
      add_from<1>(acc, v.y);
      add_from<2>(acc, v.z);
      add_from<3>(acc, v.w);
    } else {
      add_from<0>(acc, v.x);  // words 2r - 2, 2r - 1
      add_from<0>(acc, v.y);
      add_from<0>(acc, v.z);  // word 2r
      add_from<1>(acc, v.w);
      v = *reinterpret_cast<const float4*>(w + 4 * last + 4);
      add_from<2>(acc, v.x);
      add_from<3>(acc, v.y);
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// the x-sum row at p (a column pair), then p steps one row down the
// circular buffer [lo, end)
__device__ __forceinline__ float2 next_row(const float*& p, const float* lo,
                                           const float* end) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  p += TN;
  if (p == end) p = lo;
  return v;
}

// The RY outputs of a column pair down the x-sum rows from p: output j =
// rows j .. j + 2r, added top to bottom.
template <int R>
__device__ __forceinline__ void y_sums(float2 (&acc)[RY], const float* p,
                                       const float* lo, const float* end,
                                       int r) {
  if constexpr (R >= 0) {
#pragma unroll
    for (int e = 0; e < RY + 2 * R; ++e) {
      const float2 v = next_row(p, lo, end);
#pragma unroll
      for (int k = 0; k < RY; ++k) {
        const int d = e - k;
        if (d >= 0 && d <= 2 * R) term(acc[k], v, d);
      }
    }
  } else {
    // r >= 4: rows 0..7 are the head
    head<0>(acc, next_row(p, lo, end));
    head<1>(acc, next_row(p, lo, end));
    head<2>(acc, next_row(p, lo, end));
    head<3>(acc, next_row(p, lo, end));
    head<4>(acc, next_row(p, lo, end));
    head<5>(acc, next_row(p, lo, end));
    head<6>(acc, next_row(p, lo, end));
    head<7>(acc, next_row(p, lo, end));
#pragma unroll 2
    for (int e = RY; e <= 2 * r; ++e) add_from<0>(acc, next_row(p, lo, end));
    add_from<1>(acc, next_row(p, lo, end));
    add_from<2>(acc, next_row(p, lo, end));
    add_from<3>(acc, next_row(p, lo, end));
    add_from<4>(acc, next_row(p, lo, end));
    add_from<5>(acc, next_row(p, lo, end));
    add_from<6>(acc, next_row(p, lo, end));
    add_from<7>(acc, next_row(p, lo, end));
  }
}

// R >= 0: an instance for that radius; R = -1: any r in 4..64.
template <int R>
__global__ void __launch_bounds__(THREADS, 2)
    blur2d_kernel(const __grid_constant__ CUtensorMap map,
                  const float* __restrict__ a, float* __restrict__ out,
                  int m, int n, int r_arg, int box_w, int band_rows,
                  int mode) {
  const int r = R >= 0 ? R : r_arg;
  extern __shared__ unsigned char smem_raw[];
  // TMA writes a box at a 128-byte-aligned address; a stage is box_w * 128
  // bytes
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  const int stage = S * box_w;
  const int rows_b = 2 * r + 2 * S;  // x-sum rows in the circular buffer
  float* xb = ring + NST * stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(xb + rows_b * TN);

  // strips start delta columns left of a multiple of TN, so that a box's
  // first column x0 - r is a multiple of 4 (16 bytes), as TMA needs
  const int delta = strip_shift(r);
  const int strips =
      static_cast<int>((static_cast<long long>(n) + delta + TN - 1) / TN);
  const int x0 = static_cast<int>(
      static_cast<long long>(blockIdx.x % strips) * TN - delta);
  const int y0 = static_cast<int>(blockIdx.x / strips) * band_rows;
  const int rows = min(band_rows, m - y0);
  const int steps = (rows + 2 * r + S - 1) / S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // stage k: input rows y0 - r + k S .. + S, columns x0 - r .. + box_w
  const CUtensorMap* pmap = &map;
  auto issue = [&](int k) {
    const uint32_t bar = smem_u32(&full[k % NST]);
    mbar_expect_tx(bar, static_cast<uint32_t>(stage) * 4);
    tma_load(smem_u32(ring + (k % NST) * stage), pmap, x0 - r,
             y0 - r + k * S, bar);
  };
  auto copy = [&](int k) {
    float* dst = ring + (k % NST) * stage;
    for (int i = warp; i < S; i += WARPS) {
      const long long gy = static_cast<long long>(y0) - r +
                           static_cast<long long>(k) * S + i;
      const bool row_in = gy >= 0 && gy < m;
      const float* src = a + (row_in ? gy : 0) * static_cast<long long>(n);
      for (int j = lane; j < box_w; j += 32) {
        const long long gx = static_cast<long long>(x0) - r + j;
        const bool in = row_in && gx >= 0 && gx < n;
        cp_async4(smem_u32(dst + i * box_w + j), in ? src + gx : a, in);
      }
    }
  };

  if (mode == MODE_TMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < NST; ++s) mbar_init(smem_u32(&full[s]), 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < min(NST, steps); ++k) issue(k);
  } else {
    for (int k = 0; k < NST; ++k) {
      if (k < steps) copy(k);
      cp_async_commit();
    }
  }

  // y pass: warp pair g sums output rows RY g .. RY g + 7 of a stage's S,
  // warp % 2 the strip's left or right 64 columns
  const int g = warp / 2;
  const int ycol = (warp % 2) * 64 + 2 * lane;
  const float* ylo = xb + ycol;
  const float* yend = ylo + rows_b * TN;
  const long long col = static_cast<long long>(x0) + ycol;
  // 8-byte stores (out is 16-byte aligned)
  const bool pairs = n % 2 == 0 && x0 % 2 == 0;

  int xs = 0;  // buffer row of the stage's first x-sum row: k S mod rows_b
  for (int k = 0; k < steps; ++k) {
    const float* st = ring + (k % NST) * stage;
    if (mode == MODE_TMA) {
      mbar_wait(smem_u32(&full[k % NST]), (k / NST) & 1);
    } else {
      cp_async_wait<NST - 1>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < S / WARPS; ++i) {
      const int row = warp + WARPS * i;
      const float4 v = x_sums<R>(st + row * box_w + RX * lane, r);
      int xr = xs + row;
      if (xr >= rows_b) xr -= rows_b;
      *reinterpret_cast<float4*>(xb + xr * TN + RX * lane) = v;
    }
    // the stage's x-sums are written and its ring slot is read
    __syncthreads();
    if (k + NST < steps) {
      if (mode == MODE_TMA) {
        if (threadIdx.x == 0) issue(k + NST);
      } else {
        copy(k + NST);
      }
    }
    if (mode != MODE_TMA) cp_async_commit();

    // outputs y0 - 2r + k S + [RY g, RY g + RY): rows of x-sums from
    // y0 - 3r + k S + RY g on, buffer row xs + RY g - 2r (mod rows_b)
    const long long ob = static_cast<long long>(y0) - 2 * r +
                         static_cast<long long>(k) * S + RY * g;
    if (ob + RY > y0 && ob < static_cast<long long>(y0) + rows) {
      int s0 = xs + RY * g - 2 * r;
      if (s0 < 0) {
        s0 += rows_b;
      } else if (s0 >= rows_b) {
        s0 -= rows_b;
      }
      float2 acc[RY];
      y_sums<R>(acc, ylo + s0 * TN, ylo, yend, r);
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const long long o = ob + j;
        if (o < y0 || o >= static_cast<long long>(y0) + rows) continue;
        float* dst = out + o * n + col;
        if (pairs && col >= 0 && col + 1 < n) {
          __stcs(reinterpret_cast<float2*>(dst), acc[j]);
        } else {
          if (col >= 0 && col < n) __stcs(dst, acc[j].x);
          if (col + 1 >= 0 && col + 1 < n) __stcs(dst + 1, acc[j].y);
        }
      }
    }
    xs += S;
    if (xs >= rows_b) xs -= rows_b;
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, a libcuda entry point, taken from the
// libcuda.so.1 the runtime has loaded (no link against libcuda); null if
// it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

template <int R>
int launch(const CUtensorMap& map, const float* a, float* out, int m, int n,
           int r, int box_w, int band_rows, int mode, int smem,
           unsigned blocks, cudaStream_t stream) {
  // raise the instance's limit to the most a block may take, once a
  // device (the attribute applies to the current device only)
  static uint64_t raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !(raised >> dev & 1))) {
    e = cudaFuncSetAttribute(blur2d_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  blur2d_kernel<R><<<blocks, THREADS, smem, stream>>>(
      map, a, out, m, n, r, box_w, band_rows, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of K19. mode: MODE_TMA or MODE_PLAIN, band_rows: rows a block
// walks down (both as ops/stencil.py:blur_plan gives them). Returns 0, a
// cudaError_t, or minus the CUresult of a refused tensor map.
extern "C" int blur2d_f32(const void* a, void* out, int m, int n, int radius,
                          int mode, int band_rows, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (radius < 0 || radius > MAX_RADIUS || band_rows <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (mode != MODE_TMA && mode != MODE_PLAIN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int box_w = box_width(radius);
  const int smem = smem_bytes(radius, box_w);
  const long long blocks = ((static_cast<long long>(n) +
                             strip_shift(radius) + TN - 1) / TN) *
                           ((m + static_cast<long long>(band_rows) - 1) /
                            band_rows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (mode == MODE_TMA) {
    // the map's row stride is a multiple of 16 bytes, its base 16-byte
    // aligned, and a box's row coordinate (< m + r) fits an int
    if (n % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
        m > INT_MAX - MAX_RADIUS)
      return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                          static_cast<cuuint64_t>(m)};
    cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
    cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), S};
    cuuint32_t elem_strides[2] = {1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(a), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }
  const auto* pa = static_cast<const float*>(a);
  auto* po = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  switch (radius) {
    case 0:
      return launch<0>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                       smem, nb, st);
    case 1:
      return launch<1>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                       smem, nb, st);
    case 2:
      return launch<2>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                       smem, nb, st);
    case 3:
      return launch<3>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                       smem, nb, st);
    case 8:
      return launch<8>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                       smem, nb, st);
    default:
      return launch<-1>(map, pa, po, m, n, radius, box_w, band_rows, mode,
                        smem, nb, st);
  }
}
