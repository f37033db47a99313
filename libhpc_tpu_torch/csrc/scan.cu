// scan.cu — exclusive prefix sum of a 1-D array for Hopper (sm_90a), K13
// (float32) and K14 (32-bit integers).
//
// Replaces the TPU kernels libhpc_tpu/ops/scan.py:_scan_mxu_kernel (f32: the
// in-row prefix as X @ triu(1) on the MXU at Precision.HIGHEST, K13) and
// :_scan_tile_kernel (exact integer shift-add scan, K14). Both compute
//
//   out[i] = x[0] + x[1] + ... + x[i-1]        (out[0] = 0)
//
// in the input's type: f32 adds, or 32-bit two's-complement adds that wrap
// as the reference's int32 adds do (done here in uint32, where wrapping is
// defined).
//
// What bounds it: bytes. x is read once and out written once, 8 bytes an
// element (1.19 ms for 500M at the H100's 3.35 TB/s); the status words add
// 8 bytes a tile of TILE = 8192 elements.
//
// Design: the TPU grid runs in order, so the reference carries the running
// sum from one grid step to the next in SMEM. Hopper blocks run in no
// order, so the carry becomes a look-back: the single-pass scan with
// decoupled look-back of Merrill and Garland ("Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA NVR-2016-002), one kernel, one
// launch.
//   - Tile ids come from an atomic counter, not from blockIdx: every tile
//     a block waits on then belongs to a block that has already started,
//     so the scan cannot deadlock whatever order the hardware schedules
//     blocks in.
//   - A status word is one 64-bit word, flag in the high half and the
//     value's bits in the low half, so flag and value are never seen torn.
//     Nothing else is published through it (a value read is used only in
//     sums), so relaxed gpu-scope loads and stores order all that needs
//     ordering; acquire and release would cost every poll a fence. Waits
//     back off with __nanosleep; a wait of about 10 s traps rather than
//     hangs the card.
//   - The grid is persistent (as many blocks as fit on the card), and a
//     block is 8 compute warps and one look-back warp, so that a block's
//     loads go on while it waits for a look-back. (With one tile a block,
//     a block holds its slot through its look-back and loads nothing
//     meanwhile: the rate of bytes fell well below HBM's.)
//   - Compute warps, tile T_i in buffer i % 3 (a ring of three):
//       1. sum the tile (each thread its 32 contiguous elements, warp
//          shuffles, warp 0 over the warp totals) and publish
//          (AGGREGATE, aggregate), or (INCLUSIVE, aggregate) for tile 0;
//          hand T_i to the look-back warp (named barrier READY);
//       2. claim T_{i+1} and start its 16-byte cp.async copies into the
//          third buffer;
//       3. wait for T_{i-1}'s prefix (named barrier DONE), add it to
//          T_{i-1}'s elements in shared memory and store them once, in
//          16-byte streaming stores;
//       4. wait for T_{i+1}'s copies.
//     Between a tile's claim and its AGGREGATE the only wait is step 3,
//     for the previous tile's look-back, which needs only tiles claimed
//     before it: no chain of look-backs can close into a cycle.
//   - The look-back warp, for T_i: reads the predecessors' status words a
//     warp's width at a time, nearest first, and adds their values up to
//     the nearest INCLUSIVE one, which already holds the sum of everything
//     before it; publishes (INCLUSIVE, prefix + aggregate); passes the
//     prefix back (DONE).
//   - Buffers hold the tile in rows of 32 elements padded to 36 words: the
//     copies (8 chunks of 16 bytes a row), each thread's reads of its 32
//     elements (16-byte loads, twice: for its total, then for its prefix
//     sums) and the write-back are free of bank conflicts.
// Integer adds wrap and are associative: K14 is exact. K13 adds in FP32 on
// the CUDA cores (a TF32 tensor-core product, the analogue of the
// reference's matmul, would keep 10 of the 23 mantissa bits); where a
// look-back stops decides how the tiles' aggregates associate, so its last
// bits may differ from run to run, as CUB's float scan's do. Element
// offsets are 64-bit.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // compute threads a block
constexpr int ALL = THREADS + 32;     // and the look-back warp
constexpr int ITEMS = 32;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = TILE / 4;      // 16-byte chunks of a tile
constexpr int ROW = 36;               // words a row of 32 elements takes
constexpr int BUF = TILE / 32 * ROW;  // words of a tile buffer
constexpr int NBUF = 3;  // T_{i-1} to store, T_i to sum, T_{i+1} to load
constexpr int SMEM_BYTES = NBUF * BUF * 4;
// named barriers: 0 is __syncthreads; COMPUTE joins the compute warps;
// READY + s and DONE + s hand the tile of buffer s to the look-back warp
// and its prefix back
constexpr int COMPUTE = 1, READY = 2, DONE = READY + NBUF;
constexpr unsigned FULL = 0xffffffffu;
// status word flags (high half); 0: the tile has published nothing yet
constexpr unsigned long long AGGREGATE = 1, INCLUSIVE = 2;
// a look-back that polls this long (about 10 s at the card's clock) waits
// for a tile that never publishes: trap rather than hang the card
constexpr long long HANG_CYCLES = 20000000000LL;

// word offset of 16-byte chunk c in a tile buffer (8 chunks a padded row)
__device__ __forceinline__ int chunk_at(int c) {
  return (c >> 3) * ROW + (c & 7) * 4;
}

__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) {
  return b;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag,
                                        uint32_t value) {
  const unsigned long long w = flag << 32 | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the shared-memory writes before it are seen by the threads that pass the
// barrier's bar.sync
__device__ __forceinline__ void named_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// 16-byte copy into shared memory of the first `bytes` (0 to 16) bytes at
// src; the rest of the 16 is filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes) : "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// inclusive and exclusive scans of one value per lane
template <typename T>
__device__ __forceinline__ void warp_scan(T v, T& incl, T& excl) {
  const int lane = threadIdx.x & 31;
  incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = T(0);
}

// Starts the copies of tile t of x into buf (the compute threads), one
// cp.async group: 16-byte copies where x is aligned (a chunk across n
// copies the bytes before n, one past n none; the rest is zero-filled),
// else plain loads.
template <typename T>
__device__ __forceinline__ void fetch(T* buf, const T* x, int64_t n, int t,
                                      bool vec) {
  const int64_t base = static_cast<int64_t>(t) * TILE;
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    const int c = j * THREADS + static_cast<int>(threadIdx.x);
    const int64_t i = base + 4 * c;
    T* dst = buf + chunk_at(c);
    if (vec) {
      const int64_t left = n - i;
      const int bytes = left >= 4 ? 16 : left > 0 ? static_cast<int>(left) * 4
                                                  : 0;
      cp_async16(dst, bytes > 0 ? x + i : x, bytes);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = i + e < n ? x[i + e] : T(0);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Called by one whole warp for a tile t > 0 whose aggregate is published:
// the sum of every tile before t (lane 0's is the one used).
template <typename T>
__device__ T look_back(const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  T prefix = T(0);
  for (int j = t - 1 - lane;; j -= 32) {  // this lane's predecessor
    // before tile 0: an INCLUSIVE zero (tile 0 itself stops the walk first)
    unsigned long long w = j >= 0 ? peek(status + j) : INCLUSIVE << 32;
    unsigned inclusive;
    long long t0 = -1;
    unsigned ns = 8;
    for (;;) {
      inclusive = __ballot_sync(FULL, (w >> 32) == INCLUSIVE);
      // the lanes up to the nearest INCLUSIVE one must have published (all
      // 32 where none is INCLUSIVE)
      const unsigned need = inclusive ? inclusive ^ (inclusive - 1) : FULL;
      if (!(__ballot_sync(FULL, (w >> 32) == 0) & need)) break;
      const long long now = clock64();
      if (t0 < 0) {
        t0 = now;
      } else if (now - t0 > HANG_CYCLES) {
        __trap();
      }
      __nanosleep(ns);
      if (ns < 256) ns *= 2;
      if ((w >> 32) == 0) w = peek(status + j);
    }
    T v = from_bits<T>(static_cast<uint32_t>(w));
    if (inclusive && lane > __ffs(inclusive) - 1) v = T(0);
    prefix += warp_sum(v);
    if (inclusive) break;
  }
  return prefix;
}

// status[0]'s low half counts the tiles claimed; status[1 + t] is tile t's
// word. The wrapper zeroes all of it before the launch. vec: x and out are
// 16-byte aligned. Dynamic shared memory: SMEM_BYTES.
template <typename T>
__global__ void __launch_bounds__(ALL)
    scan_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                int tiles, unsigned long long* __restrict__ status,
                bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const bufs = reinterpret_cast<T*>(smem);
  __shared__ T warp_ex[NBUF][WARPS];  // the warps' offsets in each tile
  __shared__ T aggregate_of[NBUF], prefix_of[NBUF];
  __shared__ int tile_of[NBUF];       // -1: no tile, the look-back warp ends
  __shared__ int claimed;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto* const counter = reinterpret_cast<unsigned int*>(status);
  unsigned long long* const words = status + 1;

  if (warp == WARPS) {  // the look-back warp
    for (int i = 0;; ++i) {
      const int s = i % NBUF;
      named_sync(READY + s, ALL);
      const int t = tile_of[s];
      if (t < 0) return;
      T prefix = T(0);
      if (t > 0) {
        prefix = look_back<T>(words, t);
        if (lane == 0)
          publish(words + t, INCLUSIVE, to_bits(prefix + aggregate_of[s]));
      }
      if (lane == 0) prefix_of[s] = prefix;
      named_arrive(DONE + s, ALL);
    }
  }

  if (threadIdx.x == 0) claimed = static_cast<int>(atomicAdd(counter, 1u));
  named_sync(COMPUTE, THREADS);
  int t = claimed;
  if (t < tiles) fetch(bufs, x, n, t, vec);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  named_sync(COMPUTE, THREADS);

  const int mine = ITEMS / 4 * static_cast<int>(threadIdx.x);  // chunks
  int prev = -1;      // T_{i-1}
  T prev_ex = T(0);   // this thread's offset in T_{i-1}
  for (int i = 0;; ++i) {
    const int s = i % NBUF, sp = (i + NBUF - 1) % NBUF;
    const int sn = (i + 1) % NBUF;
    T ex = T(0);
    // 1. T_i's aggregate, published; T_i to the look-back warp
    if (t < tiles) {
      const T* b = bufs + s * BUF;
      T run = T(0);
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q) {
        const uint4 w = *reinterpret_cast<const uint4*>(b + chunk_at(mine + q));
        run += from_bits<T>(w.x);
        run += from_bits<T>(w.y);
        run += from_bits<T>(w.z);
        run += from_bits<T>(w.w);
      }
      T incl;
      warp_scan(run, incl, ex);
      if (lane == 31) warp_ex[s][warp] = incl;
      named_sync(COMPUTE, THREADS);
      if (warp == 0) {
        T wi, we;
        warp_scan(lane < WARPS ? warp_ex[s][lane] : T(0), wi, we);
        if (lane < WARPS) warp_ex[s][lane] = we;
        const T aggregate = __shfl_sync(FULL, wi, WARPS - 1);
        if (lane == 0) {
          publish(words + t, t == 0 ? INCLUSIVE : AGGREGATE,
                  to_bits(aggregate));
          tile_of[s] = t;
          aggregate_of[s] = aggregate;
        }
      }
    } else if (threadIdx.x == 0) {
      tile_of[s] = -1;
    }
    named_arrive(READY + s, ALL);

    // 2. claim T_{i+1} and start its copies (its buffer held T_{i-2})
    int next = tiles;
    if (t < tiles) {
      if (threadIdx.x == 0)
        claimed = static_cast<int>(atomicAdd(counter, 1u));
      named_sync(COMPUTE, THREADS);
      next = claimed;
      if (next < tiles) fetch(bufs + sn * BUF, x, n, next, vec);
    }

    // 3. T_{i-1}: its prefix, then one write of out
    if (i > 0) {
      named_sync(DONE + sp, ALL);
      T* b = bufs + sp * BUF;
      const T off = prefix_of[sp] + warp_ex[sp][warp] + prev_ex;
      T run = T(0);  // the thread's own exclusive sums, each added once
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q) {
        uint4* p = reinterpret_cast<uint4*>(b + chunk_at(mine + q));
        const uint4 w = *p;
        uint4 o;
        o.x = to_bits(off + run);
        run += from_bits<T>(w.x);
        o.y = to_bits(off + run);
        run += from_bits<T>(w.y);
        o.z = to_bits(off + run);
        run += from_bits<T>(w.z);
        o.w = to_bits(off + run);
        run += from_bits<T>(w.w);
        *p = o;
      }
      named_sync(COMPUTE, THREADS);
      const int64_t base = static_cast<int64_t>(prev) * TILE;
#pragma unroll
      for (int j = 0; j < CHUNKS / THREADS; ++j) {
        const int c = j * THREADS + static_cast<int>(threadIdx.x);
        const int64_t e0 = base + 4 * c;
        const T* src = b + chunk_at(c);
        if (vec && e0 + 4 <= n) {
          __stcs(reinterpret_cast<uint4*>(out + e0),
                 *reinterpret_cast<const uint4*>(src));
        } else {
          for (int e = 0; e < 4; ++e)
            if (e0 + e < n) out[e0 + e] = src[e];
        }
      }
    }
    if (t >= tiles) return;

    // 4. T_{i+1} has landed (every thread's copies), and T_{i-1}'s buffer
    // is free
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    named_sync(COMPUTE, THREADS);
    prev = t;
    prev_ex = ex;
    t = next;
  }
}

// status: ceil(n / TILE) + 1 zeroed 64-bit words
// (ops/scan.py:scan_scratch_len). The grid is as many blocks as fit on the
// card at once, at most one a tile.
template <typename T>
int scan_launch(const void* x, void* out, void* status, int n,
                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tiles = static_cast<int>((static_cast<int64_t>(n) + TILE - 1)
                                     / TILE);
  // the ring passes the 48 KB a block gets unasked; with the largest
  // shared-memory carve-out two blocks fit an SM
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<T>,
                                                      ALL, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::min(tiles, sms * std::max(per_sm, 1));
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  scan_kernel<T><<<blocks, ALL, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, tiles,
      static_cast<unsigned long long*>(status), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scan_exclusive_f32(const void* x, void* out, void* status,
                                  int n, void* stream) {
  return scan_launch<float>(x, out, status, n, stream);
}

extern "C" int scan_exclusive_i32(const void* x, void* out, void* status,
                                  int n, void* stream) {
  return scan_launch<uint32_t>(x, out, status, n, stream);
}
