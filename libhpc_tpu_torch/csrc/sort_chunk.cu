// sort_chunk.cu — the chunk sorts of the merge-path sorts for Hopper
// (sm_90a), K8 and K11: one block-local LSD radix sort.
//
// Replaces the TPU kernels libhpc_tpu/ops/sort_pallas.py:131 _chunk_kernel
// (K8, keys) and libhpc_tpu/ops/sort_pallas_kv.py:87 _chunk_kernel_kv
// (K11, a 32-bit payload beside every key). For chunk c of C = 2^log2c raw
// u32 bit patterns x[cC .. cC+C), where x holds n_valid of them and the
// rest count as 0xFFFFFFFF with payload 0 (the sort's pad, so that a
// segment need not be copied to its padded length first):
//
//   y = x ^ 0x80000000                  (u32 order becomes int32 order)
//   out[pad + cC .. pad + cC + C) = y sorted, descending iff
//       desc(c) = (alternate ? c odd : false) != invert
//   and XOR 0x80000000 once more when unflip; for K11 each payload moves
//   with its key.
//
// What bounds it: global memory is read and written once, 8 bytes an
// element (16 with payloads): 0.160 ms for 2^26 keys over 3.35 TB/s. What
// it takes is shared memory: about five accesses a key and pass (count,
// scatter, read-back; two more a payload) and the scatter's bank
// conflicts. The TPU kernels' bitonic network makes log2c (log2c + 1) / 2
// barrier-separated passes over the chunk instead, 91 at 2^13, two
// accesses a key each.
//
// Design, chunk_sort_kernel<KV, BITS>: one block a chunk, T = C / ITEMS
// threads (at least one warp, at most 512), thread t holding the ITEMS =
// 32 keys (and payloads) at positions t ITEMS .. t ITEMS + ITEMS - 1 in
// registers, so positions are ordered by (thread, item). (8 and 16 keys a
// thread were slower at 2^13 and 2^14: PERF.md, PR 12.)
//   - Direction by conjugation: a descending chunk is sorted ascending as
//     u = ~x (bitwise NOT reverses the order) and NOT-ed back on the way
//     out, so no pass knows about direction. The digits come from the
//     unsigned bits of that domain, u = x ^ dmask (dmask = desc ? ~0 : 0),
//     which is y ^ 0x80000000: sorting u as unsigned is sorting y as
//     int32. A descending chunk also reads its keys in reverse (position
//     p holds element C - 1 - p), so that it comes out as the mirror image
//     of the ascending sort, ties in reverse input order, exactly as the
//     plain version's stable sort and flip.
//   - ceil(32 / BITS) stable passes of BITS bits, ranked by per-thread
//     counters (as CUB's BlockRadixRank does). Each pass:
//       1. counts: thread t's count of digit d is the low (d < R/2) or the
//          high 16 bits of word (d mod R/2, t) of R/2 rows of T words; a
//          thread adds its items in position order;
//       2. one exclusive scan of the words in (row, thread) order gives,
//          in the low halves, the first output position of each (digit,
//          thread) of the low digits, and in the high halves that of the
//          high digits less the count of all low digits, which is added;
//       3. scatters each item, in an exchange buffer, to the start of its
//          (digit, thread) plus its rank among the thread's items of its
//          digit, which the count kept in a byte; each thread reads its
//          positions back for the next pass.
//     Keys of one digit keep their order in every pass, so the sort is
//     stable (K11 keeps the input order of equal keys in an ascending
//     chunk).
//   - Bank conflicts: thread t's counters are column t of rows whose
//     stride is a multiple of 32 words, so a warp's counter accesses fall
//     on nearly distinct banks whatever its digits; a spare word after
//     every R/2 words of a row puts the scan's runs of R/2 words on
//     distinct banks; indices into the exchange buffer skip one word in
//     every 32 (padx), so that a thread's run of positions does too.
//   - Global memory: a thread reads its ITEMS keys as 16-byte loads, all
//     in flight together, where the chunk is whole and aligned, and the
//     block writes the sorted chunk in 16-byte stores where aligned;
//     elsewhere (a short last chunk: the pad) element by element.
//   - A chunk of fewer than 32 ITEMS keys fills its warp's positions past
//     C with 0xFFFFFFFF, which sort after every key of the chunk
//     (stability) and are never written.
//   - Registers: a thread holds its keys (and payloads) and their ranks,
//     a byte each, within 128 registers at 512 threads. The scan's loops
//     are only partly unrolled, so that its loads do not crowd out the
//     keys (ptxas spilled otherwise).
//   - Shared memory: the exchange buffer (4 bytes a key, and 4 a payload,
//     padded by 1/32) and R/2 counter words a thread: 2^14 keys and
//     payloads at BITS = 6 take 200 KB. Above 48 KB a kernel must opt in
//     (cudaFuncSetAttribute), once an instance and device, before any
//     graph capture.
//
// Instances: BITS in {4, 5, 6}, keys alone and with payloads, for chunks
// of up to 2^14. The wrappers (ops/sort_merge.py:chunk_sort_kernel,
// ops/sort_merge_kv.py:chunk_sort_kv_kernel) pick BITS and the largest
// chunk from chip_smoke.py's chunk_sort_sweep.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LOG2C = 14;       // 2^14 keys (and payloads) a block
constexpr int ITEMS = 32;           // keys a thread
constexpr int MAX_THREADS = (1 << MAX_LOG2C) / ITEMS;
constexpr int MAX_SMEM = 232448;    // bytes a block may opt in to
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t FLIP = 0x80000000u;

// one spare word after every 32
__host__ __device__ constexpr int padx(int e) { return e + (e >> 5); }

// row stride of the counters: a row of T words with one spare word after
// every HALF, rounded up to whole rows of banks
__host__ __device__ constexpr int cnt_stride(int threads, int half) {
  return (threads + threads / half + 31) & ~31;
}

constexpr int smem_bytes(bool kv, int bits, int threads) {
  const int half = (1 << bits) / 2;
  const int words = (kv ? 2 : 1) * padx(threads * ITEMS) +
                    half * cnt_stride(threads, half) + 33;
  return words * static_cast<int>(sizeof(uint32_t));
}
// the largest block, 2^14 keys and payloads in 6-bit digits, fits
static_assert(smem_bytes(true, 6, MAX_THREADS) <= MAX_SMEM, "");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// thread t's ITEMS values of src (chunk at c0, C elements, n_valid in
// all): position p = t ITEMS + i holds element p, or C - 1 - p when desc;
// past n_valid `fill`, then ^ mask; past C `past`
__device__ __forceinline__ void load_items(
    uint32_t (&v)[ITEMS], const uint32_t* __restrict__ src, int64_t c0,
    int C, int64_t n_valid, bool desc, uint32_t mask, uint32_t fill,
    uint32_t past) {
  const int p0 = threadIdx.x * ITEMS;
  if (C >= ITEMS && c0 + C <= n_valid && aligned16(src + c0) && p0 < C) {
    // whole and aligned: the thread's elements are contiguous
    const uint4* s = reinterpret_cast<const uint4*>(
        src + c0 + (desc ? C - p0 - ITEMS : p0));
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const uint4 w = s[q];
      const uint32_t e[4] = {w.x, w.y, w.z, w.w};
      // register indices stay static on both sides
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (desc) v[ITEMS - 1 - (4 * q + r)] = e[r] ^ mask;
        else v[4 * q + r] = e[r] ^ mask;
      }
    }
    return;
  }
  // element by element from one base, so the loads take immediate offsets
  const int64_t real = n_valid - c0;        // elements of the chunk in src
  if (desc) {
    const uint32_t* b = src + c0 + (C - 1 - p0);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      v[i] = p0 + i < C ? (C - 1 - p0 - i < real ? b[-i] : fill) ^ mask
                        : past;
  } else {
    const uint32_t* b = src + c0 + p0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      v[i] = p0 + i < C ? (p0 + i < real ? b[i] : fill) ^ mask : past;
  }
}

// the first C positions of the exchange buffer, ^ mask, to dst
__device__ __forceinline__ void store_chunk(uint32_t* __restrict__ dst,
                                            const uint32_t* ex, int C,
                                            uint32_t mask) {
  const int T = blockDim.x;
  if (C % 4 == 0 && aligned16(dst)) {
    for (int j = threadIdx.x; j < C / 4; j += T) {
      const int e = 4 * j;
      reinterpret_cast<uint4*>(dst)[j] =
          make_uint4(ex[padx(e)] ^ mask, ex[padx(e + 1)] ^ mask,
                     ex[padx(e + 2)] ^ mask, ex[padx(e + 3)] ^ mask);
    }
  } else {
    for (int j = threadIdx.x; j < C; j += T) dst[j] = ex[padx(j)] ^ mask;
  }
}

// exclusive scan of the HALF T counter words in (row, thread) order, in
// place, with the count of the low digits added to every high half. Each
// thread takes HALF consecutive words of one row (a raking scan), which
// the spare words put on distinct banks
template <int HALF>
__device__ __forceinline__ void scan_counters(uint32_t* cnt, uint32_t* wsum,
                                              int S) {
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = threadIdx.x * HALF;        // first (row, thread) entry
  const int t0 = e0 & (T - 1);
  uint32_t* seg = cnt + (e0 / T) * S + t0 + t0 / HALF;
  // (partly unrolled: the keys stay in registers meanwhile)
  uint32_t sum = 0;
#pragma unroll 4
  for (int j = 0; j < HALF; ++j) sum += seg[j];
  uint32_t inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = T >> 5;
    const uint32_t w = lane < nw ? wsum[lane] : 0;
    uint32_t winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(FULL, winc, o);
      if (lane >= o) winc += n;
    }
    if (lane < nw) wsum[lane] = winc - w;
    if (lane == 31) wsum[32] = winc;        // the block's total
  }
  __syncthreads();
  // the low halves total at most 2^14: no carry into the high halves
  uint32_t run = inc - sum + wsum[warp] + ((wsum[32] & 0xFFFFu) << 16);
#pragma unroll 4
  for (int j = 0; j < HALF; ++j) {
    const uint32_t c = seg[j];
    seg[j] = run;
    run += c;
  }
}

template <bool KV, int BITS>
__global__ void __launch_bounds__(MAX_THREADS)
    chunk_sort_kernel(const uint32_t* __restrict__ xk,
                      const uint32_t* __restrict__ xv, int64_t n_valid,
                      uint32_t* __restrict__ ok, uint32_t* __restrict__ ov,
                      int log2c, int64_t pad, int alternate, int invert,
                      int unflip) {
  constexpr int HALF = (1 << BITS) / 2;     // counter words a thread
  constexpr int PASSES = (32 + BITS - 1) / BITS;
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int C = 1 << log2c;
  const int cp = T * ITEMS;                 // positions held by the block
  uint32_t* ex = smem;                      // keys, by position
  uint32_t* exv = smem + padx(cp);          // payloads (KV)
  const int S = cnt_stride(T, HALF);
  uint32_t* cnt = smem + (KV ? 2 : 1) * padx(cp);
  uint32_t* wsum = cnt + HALF * S;
  const int col = t + t / HALF;             // row k of thread t: k S + col
  const int64_t c0 = int64_t{blockIdx.x} << log2c;
  const bool desc = (alternate && (blockIdx.x & 1)) != (invert != 0);
  const uint32_t dmask = desc ? FULL : 0u;

  uint32_t key[ITEMS];
  uint32_t val[KV ? ITEMS : 1];
  load_items(key, xk, c0, C, n_valid, desc, dmask, FULL, FULL);
  if constexpr (KV)
    load_items(val, xv, c0, C, n_valid, desc, 0u, 0u, 0u);

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = pass * BITS;
#pragma unroll
    for (int k = 0; k < HALF; ++k) cnt[k * S + col] = 0;
    // 1. count, items in position order; an item's count so far is its
    //    rank among the thread's items of its digit (a byte: < ITEMS)
    uint32_t rank[ITEMS / 4];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const uint32_t d = (key[i] >> shift) & (2 * HALF - 1);
      const uint32_t sh = d / HALF * 16;
      const int at = (d & (HALF - 1)) * S + col;
      const uint32_t c = cnt[at];
      cnt[at] = c + (1u << sh);
      // byte i % 4 of rank[i / 4] := the low byte of c >> sh
      constexpr uint32_t SEL[4] = {0x3214, 0x3240, 0x3410, 0x4210};
      rank[i / 4] = i % 4 ? __byte_perm(rank[i / 4], c >> sh, SEL[i % 4])
                          : (c >> sh) & 0xFFu;
    }
    __syncthreads();
    // 2. counts -> first output positions
    scan_counters<HALF>(cnt, wsum, S);
    __syncthreads();
    // 3. scatter to the (digit, thread) start plus the rank, then read
    //    the positions back
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const uint32_t d = (key[i] >> shift) & (2 * HALF - 1);
      const uint32_t sh = d / HALF * 16;
      const int to = padx(((cnt[(d & (HALF - 1)) * S + col] >> sh) & 0xFFFFu) +
                          __byte_perm(rank[i / 4], 0, 0x4440 + i % 4));
      ex[to] = key[i];
      if constexpr (KV) exv[to] = val[i];
    }
    __syncthreads();
    if (pass + 1 < PASSES) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        key[i] = ex[padx(t * ITEMS + i)];
        if constexpr (KV) val[i] = exv[padx(t * ITEMS + i)];
      }
    }
  }

  // u ^ (unflip ? dmask : dmask ^ FLIP) is y ^ dmask, unflipped if asked
  store_chunk(ok + pad + c0, ex, C, unflip ? dmask : (dmask ^ FLIP));
  if constexpr (KV) store_chunk(ov + pad + c0, exv, C, 0u);
}

using ChunkKernel = void (*)(const uint32_t*, const uint32_t*, int64_t,
                             uint32_t*, uint32_t*, int, int64_t, int, int,
                             int);

template <bool KV>
ChunkKernel pick(int bits) {
  switch (bits) {
    case 4: return chunk_sort_kernel<KV, 4>;
    case 5: return chunk_sort_kernel<KV, 5>;
    case 6: return chunk_sort_kernel<KV, 6>;
    default: return nullptr;
  }
}

template <bool KV>
int chunk_launch(const void* xk, const void* xv, void* ok, void* ov,
                 int n_valid, int n_chunks, int log2c, int pad, int alternate,
                 int invert, int unflip, int bits, void* stream) {
  const ChunkKernel kern = pick<KV>(bits);
  if (kern == nullptr || log2c < 1 || log2c > MAX_LOG2C || n_chunks < 0 ||
      pad < 0 || n_valid < 0 ||
      int64_t{n_valid} > (int64_t{n_chunks} << log2c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (1 << log2c) / ITEMS < 32 ? 32 : (1 << log2c) / ITEMS;
  const int smem = smem_bytes(KV, bits, threads);
  if (n_chunks == 0) return 0;
  // raise each instance's limit to the most a block may take, once a
  // device: bits 4/5/6, keys and payloads
  static uint64_t raised[6] = {};
  const int k = (KV ? 3 : 0) + bits - 4;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !(raised[k] >> dev & 1))) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess && dev < 64) raised[k] |= uint64_t{1} << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<n_chunks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xk), static_cast<const uint32_t*>(xv),
      n_valid, static_cast<uint32_t*>(ok), static_cast<uint32_t*>(ov), log2c,
      pad, alternate, invert, unflip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n_valid raw keys (n_valid <= n_chunks 2^log2c), the rest 0xFFFFFFFF.
// bits: the digit width (4, 5, 6); log2c: 1 .. 14. Anything else returns
// cudaErrorInvalidValue.
extern "C" int sort_chunk_i32(const void* x, void* out, int n_valid,
                              int n_chunks, int log2c, int pad, int alternate,
                              int invert, int unflip, int bits,
                              void* stream) {
  return chunk_launch<false>(x, nullptr, out, nullptr, n_valid, n_chunks,
                             log2c, pad, alternate, invert, unflip, bits,
                             stream);
}

// keys and payloads: n_valid of each, the rest key 0xFFFFFFFF, payload 0.
extern "C" int sort_chunk_kv_i32(const void* xk, const void* xv, void* ok,
                                 void* ov, int n_valid, int n_chunks,
                                 int log2c, int pad, int alternate,
                                 int invert, int unflip, int bits,
                                 void* stream) {
  return chunk_launch<true>(xk, xv, ok, ov, n_valid, n_chunks, log2c, pad,
                            alternate, invert, unflip, bits, stream);
}
