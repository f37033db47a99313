// sort_merge.cu — merge-path merge of the u32 sort for Hopper (sm_90a),
// K9 and K10.
//
// Replaces the TPU kernels libhpc_tpu/ops/sort_pallas.py:_merge_kernel
// (one merge level, K9) and :_pair_merge_kernel (the fold of two segment
// buffers, K10). They differ only in their sources: a level reads both
// candidate windows from one buffer (srcA == srcB), a pair merge from two.
//
// For output window w of W = 2^log2w elements, with the merge-path split
// computed on the host side (ops/sort_merge.py:_level_scalars or
// _pair_scalars; the seven int32 arrays of the reference):
//
//   sA = rowA[w] * 128 + dA[w],  sB = rowB[w] * 128 + dB[w]
//   m  = desc[w] ? -1 : 0                    (NOT-conjugation)
//   e  = desc[w] ? W - 1 - i : i             (mirrored position)
//   a_i = e >= W - kA[w] ? +inf : srcA[sA + i] ^ m
//   b_i = e <  kB[w]     ? +inf : srcB[sB + i] ^ m
//   out[pad + wW + i] = (sort_asc(min(a, b)))_i ^ m  (^ 0x80000000 if unflip)
//
// min(a, b) of an ascending and a descending window is the lower half of
// their bitonic concatenation (the bitonic halver), itself bitonic, so the
// log2 W half-cleaner stages of a bitonic merge sort it.
//
// Design:
//   - One block per window. The TPU kernel DMAs two (W/128 + 16)-row
//     windows aligned to (8,128) tiles, double-buffered, and extracts the
//     candidates with a dynamic row slice and a lane roll. Here each thread
//     reads its candidates at sA + i and sB + i directly (coalesced,
//     64-bit offsets) and reads nothing at a masked position, so no read
//     leaves the data region.
//   - The reference's W = 2^17 (512 KB) does not fit shared memory; the
//     wrapper runs windows of at most 2^12 (16 KB) and computes the splits
//     for that W.
//
// What bounds it: each level reads and writes the whole buffer once
// (8 bytes an element), plus log2 W barrier-separated shared-memory stages.
//
// K12, sort_merge_kv_i32: the same merge with a 32-bit payload beside every
// key, the port of libhpc_tpu/ops/sort_pallas_kv.py:_merge_kernel_kv (as
// _run_merge_kv calls it, for a level or a pair). The halver keeps the B
// candidate where its key is smaller, or equal with the A candidate
// masked: a masked candidate loses every tie, so a real key equal to the
// +inf fill (0xFFFFFFFF in an ascending window, 0 in a descending one)
// keeps its own payload, where the reference's "ties keep A" lets a masked
// A candidate win. The halver never selects two masked candidates (kA +
// kB <= W), and a payload is read only for the candidate selected, so no
// masked position is read. Windows of 2^12 keys and payloads take 32 KB.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LOG2W = 12;
constexpr int MAX_THREADS = 512;
constexpr int32_t FLIP = INT32_MIN;
constexpr int32_t POS_INF = INT32_MAX;

__global__ void __launch_bounds__(MAX_THREADS)
    merge_kernel(const int32_t* __restrict__ srcA,
                 const int32_t* __restrict__ srcB,
                 const int32_t* __restrict__ rowA,
                 const int32_t* __restrict__ dA,
                 const int32_t* __restrict__ rowB,
                 const int32_t* __restrict__ dB,
                 const int32_t* __restrict__ kA,
                 const int32_t* __restrict__ kB,
                 const int32_t* __restrict__ dsc, int32_t* __restrict__ out,
                 int log2w, int64_t pad, int unflip) {
  __shared__ int32_t sh[1 << MAX_LOG2W];
  const int64_t w = blockIdx.x;
  const int W = 1 << log2w;
  const int64_t sA = static_cast<int64_t>(rowA[w]) * 128 + dA[w];
  const int64_t sB = static_cast<int64_t>(rowB[w]) * 128 + dB[w];
  const int ka = kA[w];
  const int kb = kB[w];
  const bool desc = dsc[w] != 0;
  const int32_t m = desc ? -1 : 0;

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int e = desc ? W - 1 - i : i;
    const int32_t a = (e >= W - ka) ? POS_INF : (srcA[sA + i] ^ m);
    const int32_t b = (e < kb) ? POS_INF : (srcB[sB + i] ^ m);
    sh[i] = min(a, b);
  }
  __syncthreads();

  for (int j = W >> 1; j > 0; j >>= 1) {
    for (int i = threadIdx.x; i < (W >> 1); i += blockDim.x) {
      const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
      const int hi = lo + j;
      const int32_t a = sh[lo];
      const int32_t b = sh[hi];
      if (a > b) {
        sh[lo] = b;
        sh[hi] = a;
      }
    }
    __syncthreads();
  }

  const int32_t omask = unflip ? (m ^ FLIP) : m;
  int32_t* dst = out + pad + w * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) dst[i] = sh[i] ^ omask;
}

__global__ void __launch_bounds__(MAX_THREADS)
    merge_kv_kernel(const int32_t* __restrict__ srcAk,
                    const int32_t* __restrict__ srcAv,
                    const int32_t* __restrict__ srcBk,
                    const int32_t* __restrict__ srcBv,
                    const int32_t* __restrict__ rowA,
                    const int32_t* __restrict__ dA,
                    const int32_t* __restrict__ rowB,
                    const int32_t* __restrict__ dB,
                    const int32_t* __restrict__ kA,
                    const int32_t* __restrict__ kB,
                    const int32_t* __restrict__ dsc,
                    int32_t* __restrict__ outk, int32_t* __restrict__ outv,
                    int log2w, int64_t pad, int unflip) {
  __shared__ int32_t shk[1 << MAX_LOG2W];
  __shared__ int32_t shv[1 << MAX_LOG2W];
  const int64_t w = blockIdx.x;
  const int W = 1 << log2w;
  const int64_t sA = static_cast<int64_t>(rowA[w]) * 128 + dA[w];
  const int64_t sB = static_cast<int64_t>(rowB[w]) * 128 + dB[w];
  const int ka = kA[w];
  const int kb = kB[w];
  const bool desc = dsc[w] != 0;
  const int32_t m = desc ? -1 : 0;

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int e = desc ? W - 1 - i : i;
    const bool maskedA = e >= W - ka;
    const bool maskedB = e < kb;
    const int32_t a = maskedA ? POS_INF : (srcAk[sA + i] ^ m);
    const int32_t b = maskedB ? POS_INF : (srcBk[sB + i] ^ m);
    const bool take_b = b < a || (b == a && maskedA && !maskedB);
    shk[i] = take_b ? b : a;
    shv[i] = take_b ? srcBv[sB + i] : srcAv[sA + i];
  }
  __syncthreads();

  for (int j = W >> 1; j > 0; j >>= 1) {
    for (int i = threadIdx.x; i < (W >> 1); i += blockDim.x) {
      const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
      const int hi = lo + j;
      const int32_t a = shk[lo];
      const int32_t b = shk[hi];
      if (a > b) {
        shk[lo] = b;
        shk[hi] = a;
        const int32_t t = shv[lo];
        shv[lo] = shv[hi];
        shv[hi] = t;
      }
    }
    __syncthreads();
  }

  const int32_t omask = unflip ? (m ^ FLIP) : m;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    outk[pad + w * W + i] = shk[i] ^ omask;
    outv[pad + w * W + i] = shv[i];
  }
}

}  // namespace

extern "C" int sort_merge_i32(const void* srcA, const void* srcB,
                              const void* rowA, const void* dA,
                              const void* rowB, const void* dB,
                              const void* kA, const void* kB,
                              const void* dsc, void* out, int n_windows,
                              int log2w, int pad, int unflip, void* stream) {
  if (log2w < 1 || log2w > MAX_LOG2W || n_windows < 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows == 0) return 0;
  int threads = (1 << log2w) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  merge_kernel<<<n_windows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(srcA), static_cast<const int32_t*>(srcB),
      static_cast<const int32_t*>(rowA), static_cast<const int32_t*>(dA),
      static_cast<const int32_t*>(rowB), static_cast<const int32_t*>(dB),
      static_cast<const int32_t*>(kA), static_cast<const int32_t*>(kB),
      static_cast<const int32_t*>(dsc), static_cast<int32_t*>(out), log2w,
      pad, unflip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sort_merge_kv_i32(const void* srcAk, const void* srcAv,
                                 const void* srcBk, const void* srcBv,
                                 const void* rowA, const void* dA,
                                 const void* rowB, const void* dB,
                                 const void* kA, const void* kB,
                                 const void* dsc, void* outk, void* outv,
                                 int n_windows, int log2w, int pad,
                                 int unflip, void* stream) {
  if (log2w < 1 || log2w > MAX_LOG2W || n_windows < 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows == 0) return 0;
  int threads = (1 << log2w) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  merge_kv_kernel<<<n_windows, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(srcAk), static_cast<const int32_t*>(srcAv),
      static_cast<const int32_t*>(srcBk), static_cast<const int32_t*>(srcBv),
      static_cast<const int32_t*>(rowA), static_cast<const int32_t*>(dA),
      static_cast<const int32_t*>(rowB), static_cast<const int32_t*>(dB),
      static_cast<const int32_t*>(kA), static_cast<const int32_t*>(kB),
      static_cast<const int32_t*>(dsc), static_cast<int32_t*>(outk),
      static_cast<int32_t*>(outv), log2w, pad, unflip);
  return static_cast<int>(cudaGetLastError());
}
