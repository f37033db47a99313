// sbell_spmv.cu — the SBELL SpMV for Hopper (sm_90a): near tiles and the
// FarPane far set, in one kernel.
//
// Replaces the TPU kernels libhpc_tpu/ops/spmv_pallas.py:_kernel (K1, x
// resident in VMEM), libhpc_tpu/ops/spmv_pallas.py:_ranged_kernel (K2, the
// row-chunked variant, which exists only because x and the output had to
// fit the TPU's VMEM; here x is read from global memory, so one kernel
// serves both) and libhpc_tpu/ops/far_pallas.py:_kernel (K3).
//
// What it computes, in the guarded pane layout of ops/spmv_sbell.py
// (x3[p, j, l] = x[1024 p + 8 l + j], out[8 s + i, r] = y[1024 s + 8 r + i]):
//
//   near[8 s + i, slot] = sum over the tiles t of stripe s of
//        sum_j V[t, 8 j + i, slot] * x3[pane[t] + (m >> 7), j, m & 127],
//        m = meta[t, slot]
//   far[8 s + i, r]     = sum over the entries e < e_pad of grouped stripe s
//        with olane[s, e] == r, in entry order, of
//        sum_j bt[64 s + 8 j + i, e] * x3[ep[s, e], j, lidx[s, e]]
//
// Values (V, bt) are f32 or bf16, converted in registers; every sum is f32.
// Three modes, so that each TPU kernel can still be held alone against its
// plain version:
//   MODE_NEAR  near only (K1/K2): (n_out = n_stripes + 2) stripes of output;
//   MODE_FAR   far only (K3): n_out = n_grouped stripes;
//   MODE_BOTH  near + far, added once before the store (the plain version's
//              near + far): one launch a matvec.
// Guard stripes and stripes with no tiles or no entries write zeros.
//
// What bounds it: the near value stream, 32 KB (f32) or 16 KB (bf16) a tile
// plus its 512 B meta row, read once a matvec, where the matrix is past the
// 50 MB L2; where it fits (cant_like), the chain of dependent loads a tile
// (meta row, then x). The bring-up form ran one block of 128 threads a
// stripe with scalar loads at a 512 B stride: too few bytes in flight, and
// each tile's loads waited on the one before. This design:
//   - One CTA a stripe, with a producer warp. One producer thread copies
//     all of the stripe's meta rows (contiguous) in one cp.async.bulk, then
//     streams each tile's value plane (contiguous) into a ring of STAGES
//     shared-memory stages, each completing on its own mbarrier; the
//     compute warps release a stage on an `empty` mbarrier.
//   - The x gathers run XQ = 4 tiles ahead of the values (meta rows and
//     panes sit in shared memory), so the meta -> x chain is paid about
//     once a CTA rather than once a tile.
//   - Compute: two threads a slot, each taking four of the eight j, their
//     sums added pairwise in a fixed order; each output is stored once.
//   - The far set of stripe s rides on its CTA. Its index loads are issued
//     before the near tiles, its x and value loads (real entries only) once
//     the first tile has landed, so that both latencies hide behind the
//     near loop; after it, the entries' products go to shared memory, and
//     thread r adds, in entry order, those whose olane is r. The one-hot
//     plane is never read.
// Splitting a stripe over a thread-block cluster (partials summed through
// distributed shared memory) was measured and dropped: on the main path's
// matrices one CTA a stripe was fastest (PERF.md §6).
// Offsets into the value stream and x are computed in 64-bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace {

constexpr int B = 8;
constexpr int LANE = 128;
constexpr int VROWS = B * B;
constexpr int OUT = B * LANE;            // outputs of a stripe
constexpr int HALVES = 2;                // threads a slot
constexpr int JH = B / HALVES;           // j a thread takes
constexpr int COMPUTE = HALVES * LANE;   // compute threads
constexpr int THREADS = COMPUTE + 32;    // and one producer warp
constexpr int META_BYTES = LANE * 4;
constexpr int STAGES = 3;                // stages of the tile ring
constexpr int MAX_SMEM = 232448;         // bytes a block may opt in to

constexpr int MODE_NEAR = 1;
constexpr int MODE_FAR = 2;
constexpr int MODE_BOTH = 3;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the compute threads alone (the producer warp does not take part)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(COMPUTE) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// x gathers run XQ tiles ahead of the values
constexpr int XQ = 4;

// Shared memory: [ring | far scratch] [meta rows] [panes] [barriers].
// The ring holds STAGES tiles' values. Once a CTA's tiles are
// consumed, its front serves as scratch: the far products fprod[2][B][LANE],
// the far block far[B][LANE], the entries' output lanes olane[LANE], and a
// half-sum block half[B][LANE] at HALF_OFF. The far mode has no ring, only
// that scratch.
constexpr int HALF_OFF = (3 * OUT + LANE) * 4;
constexpr int SCRATCH_BYTES = HALF_OFF + OUT * 4;

template <typename T>
__host__ __device__ constexpr int ring_bytes(bool near) {
  return near ? STAGES * VROWS * LANE * static_cast<int>(sizeof(T))
              : SCRATCH_BYTES;
}
static_assert(ring_bytes<__nv_bfloat16>(true) >= SCRATCH_BYTES,
              "the ring's front must hold the far scratch");

__host__ __device__ constexpr int smem_tail(int k_max) {
  return k_max * META_BYTES + (k_max + 3) / 4 * 16 + (1 + 2 * STAGES) * 8;
}

// The far set of grouped stripe s, in three steps so that the fused mode
// can spread its latencies over the near loop. Thread (h, e) takes entry e
// and the four j of half h:
//   far_load    its pane, x lane and output lane, issued into registers
//               (nothing waits on them yet);
//   far_gather  once the pane has landed, and for a real entry only: its x
//               values and its bt values;
//   far_finish  prod[i, e] for the rows of half h and the output lanes to
//               shared memory; then thread (h, r) adds, in entry order, the
//               products (the two halves summed first) of the entries whose
//               output lane is r, for rows i of half h, into
//               dst[i * LANE + r]. It reads the output lanes four at a
//               time and skips a group of four that holds no r.
struct FarEntry {
  int p;              // pane, -1 where there is no entry
  int li;             // x lane
  int lane;           // output lane (olane)
  float g[JH];        // x3[p, j, li] for j = JH h + jj
  float bv[JH][B];    // bt[64 s + 8 j + i, e] for j = JH h + jj
};

__device__ __forceinline__ void far_load(int s,
                                         const int32_t* __restrict__ ep,
                                         const int32_t* __restrict__ lidx,
                                         const int32_t* __restrict__ olane,
                                         int e_pad, FarEntry& f) {
  const int e = threadIdx.x % LANE;
  f.p = -1;
  f.li = 0;
  f.lane = -1;
#pragma unroll
  for (int jj = 0; jj < JH; ++jj) {
    f.g[jj] = 0.0f;
#pragma unroll
    for (int i = 0; i < B; ++i) f.bv[jj][i] = 0.0f;
  }
  if (e < e_pad) {
    const int64_t se = static_cast<int64_t>(s) * LANE + e;
    f.p = ep[se];
    f.li = lidx[se];
    f.lane = olane[se];
  }
}

template <typename T>
__device__ __forceinline__ void far_gather(int s, const T* __restrict__ bt,
                                           const float* __restrict__ x3,
                                           FarEntry& f) {
  const int h = threadIdx.x / LANE;
  const int e = threadIdx.x % LANE;
  if (f.p >= 0) {
    const float* xp = x3 + static_cast<int64_t>(f.p) * OUT + JH * h * LANE
                      + f.li;
    const T* b = bt + (static_cast<int64_t>(s) * VROWS + JH * B * h) * LANE
                 + e;
#pragma unroll
    for (int jj = 0; jj < JH; ++jj) {
      f.g[jj] = __ldg(xp + jj * LANE);
#pragma unroll
      for (int i = 0; i < B; ++i)
        f.bv[jj][i] = as_f32(b[(B * jj + i) * LANE]);
    }
  }
}

__device__ void far_finish(const FarEntry& f, int e_pad, float* fprod,
                           int* olane_s, float* dst) {
  const int h = threadIdx.x / LANE;
  const int e = threadIdx.x % LANE;
  if (e < e_pad) {
    if (h == 0) olane_s[e] = f.lane;
    float pf[B];
#pragma unroll
    for (int i = 0; i < B; ++i) pf[i] = 0.0f;
    if (f.p >= 0) {
#pragma unroll
      for (int i = 0; i < B; ++i) pf[i] = f.bv[0][i] * f.g[0];
#pragma unroll
      for (int jj = 1; jj < JH; ++jj) {
#pragma unroll
        for (int i = 0; i < B; ++i) pf[i] += f.bv[jj][i] * f.g[jj];
      }
    }
#pragma unroll
    for (int i = 0; i < B; ++i) fprod[(h * B + i) * LANE + e] = pf[i];
  }
  compute_sync();
  const int r = e;
  float acc[JH];
#pragma unroll
  for (int ii = 0; ii < JH; ++ii) acc[ii] = 0.0f;
  auto add = [&](int k) {
#pragma unroll
    for (int ii = 0; ii < JH; ++ii) {
      const int i = JH * h + ii;
      acc[ii] += fprod[i * LANE + k] + fprod[(B + i) * LANE + k];
    }
  };
  // e_pad is a multiple of 4 (the launch checks it)
  const int4* lanes4 = reinterpret_cast<const int4*>(olane_s);
  for (int k4 = 0; k4 < e_pad / 4; ++k4) {
    const int4 q = lanes4[k4];
    if (q.x != r && q.y != r && q.z != r && q.w != r) continue;
    if (q.x == r) add(4 * k4);
    if (q.y == r) add(4 * k4 + 1);
    if (q.z == r) add(4 * k4 + 2);
    if (q.w == r) add(4 * k4 + 3);
  }
#pragma unroll
  for (int ii = 0; ii < JH; ++ii) dst[(JH * h + ii) * LANE + r] = acc[ii];
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
    sbell_spmv_kernel(const T* __restrict__ vflat,
                      const int32_t* __restrict__ meta,
                      const int32_t* __restrict__ pane,
                      const int32_t* __restrict__ tile_ptr,
                      const float* __restrict__ x3,
                      const int32_t* __restrict__ ep,
                      const int32_t* __restrict__ lidx,
                      const T* __restrict__ bt,
                      const int32_t* __restrict__ olane,
                      float* __restrict__ out, int n_stripes, int e_pad,
                      int k_max) {
  constexpr bool NEAR = (MODE & MODE_NEAR) != 0;
  constexpr bool FAR = (MODE & MODE_FAR) != 0;
  constexpr int VBYTES = VROWS * LANE * static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  unsigned char* ring = smem;
  int32_t* meta_s =
      reinterpret_cast<int32_t*>(smem + ring_bytes<T>(NEAR));
  int* pane_s = reinterpret_cast<int*>(meta_s + k_max * LANE);
  uint64_t* meta_bar =
      reinterpret_cast<uint64_t*>(pane_s + (k_max + 3) / 4 * 4);
  uint64_t* vfull = meta_bar + 1;
  uint64_t* empty = vfull + STAGES;
  float* fprod = reinterpret_cast<float*>(ring);
  float* far_s = fprod + 2 * OUT;
  int* olane_s = reinterpret_cast<int*>(far_s + OUT);
  float* half_s = reinterpret_cast<float*>(ring + HALF_OFF);
  float* out_s = out + static_cast<int64_t>(s) * OUT;

  if (!NEAR) {
    // far only: one CTA a grouped stripe, every row written
    if (warp < COMPUTE / 32) {
      FarEntry f;
      far_load(s, ep, lidx, olane, e_pad, f);
      far_gather<T>(s, bt, x3, f);
      far_finish(f, e_pad, fprod, olane_s, out_s);
    }
    return;
  }

  // the stripe's tiles (none past the real stripes: guard stripes are
  // zero)
  int t_first = 0, n_mine = 0;
  if (s < n_stripes) {
    t_first = tile_ptr[s];
    n_mine = tile_ptr[s + 1] - t_first;
  }
  // k_max sizes the meta rows: a stripe deeper than the caller said would
  // overrun them
  if (n_mine > k_max) __trap();

  if (tid == 0) {
    mbar_init(smem_u32(meta_bar), 1);
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(smem_u32(&vfull[k]), 1);
      mbar_init(smem_u32(&empty[k]), COMPUTE / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const uint32_t ring0 = smem_u32(ring);
  if (warp == COMPUTE / 32) {
    // the producer: every meta row of the stripe in one copy, then tile
    // k's values into stage k % STAGES, once its last use is released
    if (tid % 32 == 0 && n_mine > 0) {
      const uint32_t mbytes = uint32_t(n_mine) * META_BYTES;
      mbar_expect_tx(smem_u32(meta_bar), mbytes);
      bulk_load(smem_u32(meta_s), meta + int64_t{t_first} * LANE, mbytes,
                smem_u32(meta_bar));
      for (int k = 0; k < n_mine; ++k) {
        const int st = k % STAGES;
        if (k >= STAGES)
          mbar_wait(smem_u32(&empty[st]), uint32_t(k / STAGES - 1) & 1);
        const int64_t t = t_first + k;
        mbar_expect_tx(smem_u32(&vfull[st]), VBYTES);
        bulk_load(ring0 + st * VBYTES, vflat + t * (VROWS * LANE), VBYTES,
                  smem_u32(&vfull[st]));
      }
    }
    return;
  }

  // the far set: its indices go out now, its x and values once the first
  // tile has landed, its products and scatter after the near tiles
  bool far_pending = FAR;            // its x and values not yet loaded
  FarEntry f;
  if (FAR) far_load(s, ep, lidx, olane, e_pad, f);
  for (int k = tid; k < n_mine; k += COMPUTE)
    pane_s[k] = __ldg(pane + t_first + k);
  compute_sync();

  const int h = tid / LANE;
  const int slot = tid % LANE;
  float acc[B];
#pragma unroll
  for (int i = 0; i < B; ++i) acc[i] = 0.0f;

  // x of tile k for this thread's four j (meta rows and panes are in
  // shared memory)
  auto gather = [&](int k, float* g) {
    const int m = meta_s[k * LANE + slot];
    const float* xp = x3 + (static_cast<int64_t>(pane_s[k]) + (m >> 7)) * OUT
                      + JH * h * LANE + (m & (LANE - 1));
#pragma unroll
    for (int jj = 0; jj < JH; ++jj) g[jj] = __ldg(xp + jj * LANE);
  };

  // a queue of XQ tiles' x, refilled XQ tiles ahead (the inner loop is
  // unrolled, so the queue stays in registers)
  float gq[XQ][JH];
  if (n_mine > 0) mbar_wait(smem_u32(meta_bar), 0);
#pragma unroll
  for (int d = 0; d < XQ; ++d)
    if (d < n_mine) gather(d, gq[d]);
  for (int k0 = 0; k0 < n_mine; k0 += XQ) {
#pragma unroll
    for (int d = 0; d < XQ; ++d) {
      const int k = k0 + d;
      if (k >= n_mine) break;
      float g[JH];
#pragma unroll
      for (int jj = 0; jj < JH; ++jj) g[jj] = gq[d][jj];
      if (k + XQ < n_mine) gather(k + XQ, gq[d]);
      const int st = k % STAGES;
      mbar_wait(smem_u32(&vfull[st]), uint32_t(k / STAGES) & 1);
      if (far_pending) {
        far_gather<T>(s, bt, x3, f);
        far_pending = false;
      }
      const T* v = reinterpret_cast<const T*>(ring + st * VBYTES)
                   + JH * B * h * LANE + slot;
      float pacc[B];
#pragma unroll
      for (int i = 0; i < B; ++i) pacc[i] = as_f32(v[i * LANE]) * g[0];
#pragma unroll
      for (int jj = 1; jj < JH; ++jj) {
#pragma unroll
        for (int i = 0; i < B; ++i)
          pacc[i] += as_f32(v[(B * jj + i) * LANE]) * g[jj];
      }
#pragma unroll
      for (int i = 0; i < B; ++i) acc[i] += pacc[i];
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(smem_u32(&empty[st]));
    }
  }

  // every tile consumed: the ring's front is scratch from here on
  compute_sync();
  if (FAR) {
    if (far_pending) far_gather<T>(s, bt, x3, f);
    far_finish(f, e_pad, fprod, olane_s, far_s);
  }

  // the two halves added in a fixed order, then the far block: the plain
  // version's near + far
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < B; ++i) half_s[i * LANE + slot] = acc[i];
  }
  compute_sync();
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      float v = acc[i] + half_s[i * LANE + slot];
      if (FAR) v += far_s[i * LANE + slot];
      out_s[i * LANE + slot] = v;
    }
  }
}

template <typename T, int MODE>
int launch_mode(const void* vflat, const void* meta, const void* pane,
                const void* tile_ptr, const void* x3, const void* ep,
                const void* lidx, const void* bt, const void* olane,
                void* out, int n_out, int n_stripes, int e_pad, int k_max,
                cudaStream_t stream) {
  auto kernel = sbell_spmv_kernel<T, MODE>;
  const int bytes = ring_bytes<T>((MODE & MODE_NEAR) != 0) + smem_tail(k_max);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // raise the instance's limit to the most a block may take, once a
  // device (the attribute applies to the current device only)
  static uint64_t raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !(raised >> dev & 1))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_out, THREADS, bytes, stream>>>(
      static_cast<const T*>(vflat), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(pane), static_cast<const int32_t*>(tile_ptr),
      static_cast<const float*>(x3), static_cast<const int32_t*>(ep),
      static_cast<const int32_t*>(lidx), static_cast<const T*>(bt),
      static_cast<const int32_t*>(olane), static_cast<float*>(out), n_stripes,
      e_pad, k_max);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vflat, const void* meta, const void* pane,
           const void* tile_ptr, const void* x3, const void* ep,
           const void* lidx, const void* bt, const void* olane, void* out,
           int n_out, int n_stripes, int e_pad, int k_max, int mode,
           void* stream) {
  const bool far_ok = e_pad > 0 && e_pad <= LANE && e_pad % 4 == 0;
  if (n_out < 0 || k_max < 0 || ((mode & MODE_FAR) && !far_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  const int km = (mode & MODE_NEAR) ? k_max : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_NEAR:
      return launch_mode<T, MODE_NEAR>(vflat, meta, pane, tile_ptr, x3, ep,
                                       lidx, bt, olane, out, n_out,
                                       n_stripes, e_pad, km, st);
    case MODE_FAR:
      return launch_mode<T, MODE_FAR>(vflat, meta, pane, tile_ptr, x3, ep,
                                      lidx, bt, olane, out, n_out, n_stripes,
                                      e_pad, km, st);
    case MODE_BOTH:
      return launch_mode<T, MODE_BOTH>(vflat, meta, pane, tile_ptr, x3, ep,
                                       lidx, bt, olane, out, n_out,
                                       n_stripes, e_pad, km, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// vflat (n_tiles * 64, 128), meta (n_tiles, 128), pane (n_tiles,),
// tile_ptr (n_stripes + 1,), x3 (n_panes + 2, 8, 128) f32; the far set
// ep, lidx, olane (n_grouped, 128) i32 and bt (n_grouped * 64, 128); out
// (n_out * 8, 128) f32. k_max: the most tiles a stripe holds (it sizes the
// meta rows in shared memory; a deeper stripe traps). mode 1 near, 2 far,
// 3 both; the pointers of the part a mode does not read may be null.
// e_pad a multiple of 4 up to 128 (FarPane pads it to 8); anything else,
// or a k_max whose meta rows pass the shared memory a block may take,
// returns cudaErrorInvalidValue.
extern "C" int sbell_spmv_f32(const void* vflat, const void* meta,
                              const void* pane, const void* tile_ptr,
                              const void* x3, const void* ep,
                              const void* lidx, const void* bt,
                              const void* olane, void* out, int n_out,
                              int n_stripes, int e_pad, int k_max, int mode,
                              void* stream) {
  return launch<float>(vflat, meta, pane, tile_ptr, x3, ep, lidx, bt, olane,
                       out, n_out, n_stripes, e_pad, k_max, mode, stream);
}

extern "C" int sbell_spmv_bf16(const void* vflat, const void* meta,
                               const void* pane, const void* tile_ptr,
                               const void* x3, const void* ep,
                               const void* lidx, const void* bt,
                               const void* olane, void* out, int n_out,
                               int n_stripes, int e_pad, int k_max, int mode,
                               void* stream) {
  return launch<__nv_bfloat16>(vflat, meta, pane, tile_ptr, x3, ep, lidx, bt,
                               olane, out, n_out, n_stripes, e_pad, k_max,
                               mode, stream);
}
