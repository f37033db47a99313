// sort_chunk.cu — chunk sort of the merge-path u32 sort for Hopper
// (sm_90a), K8.
//
// Replaces the TPU kernel libhpc_tpu/ops/sort_pallas.py:_chunk_kernel. For
// chunk c of C = 2^log2c raw u32 bit patterns x[cC .. cC+C), where x
// holds n_valid of them and the rest count as 0xFFFFFFFF (the sort's pad,
// so that a segment need not be copied to its padded length first):
//
//   y = x ^ 0x80000000                  (u32 order becomes int32 order)
//   out[pad + cC .. pad + cC + C) = y sorted, descending iff
//       desc(c) = (alternate ? c odd : false) != invert
//   and XOR 0x80000000 once more when unflip.
//
// Design:
//   - One block per chunk sorts it in shared memory with a full bitonic
//     network. Like the TPU kernel, every stage is an ascending
//     compare-exchange in a conjugated domain: a chunk that must come out
//     descending is loaded as ~y (bitwise NOT reverses int32 order), sorted
//     ascending and NOT-ed back on the way out, so there is no per-chunk
//     direction inside the network.
//   - The TPU kernel reaches partner i ^ d with lane rolls and row-block
//     pairing in VMEM; here each thread takes pairs (lo, lo + j) of shared
//     memory, lo having bit j clear, with __syncthreads between stages.
//   - Shared memory bounds the chunk: 2^13 int32 (32 KB) at most. The
//     wrapper sorts a larger chunk (the reference's default 2^16) as
//     alternating 2^13 sub-chunks and merges them with K9's kernel
//     (ops/sort_merge.py:_chunk_sort); a sorted chunk is determined
//     by its data, so the result is the same.
//
// What bounds it: the log2c (log2c + 1) / 2 barrier-separated stages of
// shared-memory compare-exchanges (91 for 2^13); global memory is read and
// written once, coalesced.
//
// K11, sort_chunk_kv_i32: the same network with a 32-bit payload beside
// every key, the port of libhpc_tpu/ops/sort_pallas_kv.py:_chunk_kernel_kv.
// The comparator decides on keys and moves key and payload together. The
// exchanges are strict, as the reference's are (equal keys never swap).
// 2^13 keys and payloads take 64 KB, above the 48 KB of static shared
// memory, so the kernel uses dynamic shared memory, opted in once with
// cudaFuncSetAttribute; the wrapper sorts the default 2^15 chunk as 2^13
// sub-chunks and two K12 levels (ops/sort_merge_kv.py:_chunk_sort_kv).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LOG2C = 13;
constexpr int MAX_THREADS = 1024;
constexpr int32_t FLIP = INT32_MIN;

__global__ void __launch_bounds__(MAX_THREADS)
    chunk_kernel(const int32_t* __restrict__ x, int64_t n_valid,
                 int32_t* __restrict__ out, int log2c, int64_t pad,
                 int alternate, int invert, int unflip) {
  __shared__ int32_t sh[1 << MAX_LOG2C];
  const int64_t c = blockIdx.x;
  const int C = 1 << log2c;
  const bool desc = (alternate && (c & 1)) != (invert != 0);
  const int32_t dmask = desc ? -1 : 0;

  const int64_t c0 = c * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    sh[i] = (c0 + i < n_valid ? x[c0 + i] : -1) ^ FLIP ^ dmask;
  __syncthreads();

  for (int k = 2; k <= C; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (C >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const int32_t a = sh[lo];
        const int32_t b = sh[hi];
        // runs of length k alternate ascending / descending
        const bool asc = (lo & k) == 0;
        if ((a > b) == asc) {
          sh[lo] = b;
          sh[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  const int32_t omask = unflip ? (dmask ^ FLIP) : dmask;
  int32_t* dst = out + pad + c * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) dst[i] = sh[i] ^ omask;
}

__global__ void __launch_bounds__(MAX_THREADS)
    chunk_kv_kernel(const int32_t* __restrict__ xk,
                    const int32_t* __restrict__ xv, int32_t* __restrict__ ok,
                    int32_t* __restrict__ ov, int log2c, int64_t pad,
                    int alternate, int invert, int unflip) {
  extern __shared__ int32_t kv_smem[];
  const int64_t c = blockIdx.x;
  const int C = 1 << log2c;
  int32_t* sk = kv_smem;
  int32_t* sv = kv_smem + C;
  const bool desc = (alternate && (c & 1)) != (invert != 0);
  const int32_t dmask = desc ? -1 : 0;

  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sk[i] = xk[c * C + i] ^ FLIP ^ dmask;
    sv[i] = xv[c * C + i];
  }
  __syncthreads();

  for (int k = 2; k <= C; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (C >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const int32_t a = sk[lo];
        const int32_t b = sk[hi];
        const bool asc = (lo & k) == 0;
        if (asc ? (a > b) : (a < b)) {
          sk[lo] = b;
          sk[hi] = a;
          const int32_t t = sv[lo];
          sv[lo] = sv[hi];
          sv[hi] = t;
        }
      }
      __syncthreads();
    }
  }

  const int32_t omask = unflip ? (dmask ^ FLIP) : dmask;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    ok[pad + c * C + i] = sk[i] ^ omask;
    ov[pad + c * C + i] = sv[i];
  }
}

}  // namespace

// x: n_valid raw keys (n_valid <= n_chunks 2^log2c), the rest 0xFFFFFFFF.
extern "C" int sort_chunk_i32(const void* x, void* out, int n_valid,
                              int n_chunks, int log2c, int pad, int alternate,
                              int invert, int unflip, void* stream) {
  if (log2c < 1 || log2c > MAX_LOG2C || n_chunks < 0 || pad < 0 ||
      n_valid < 0 || int64_t{n_valid} > (int64_t{n_chunks} << log2c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  int threads = (1 << log2c) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  chunk_kernel<<<n_chunks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), n_valid, static_cast<int32_t*>(out),
      log2c, pad, alternate, invert, unflip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sort_chunk_kv_i32(const void* xk, const void* xv, void* ok,
                                 void* ov, int n_chunks, int log2c, int pad,
                                 int alternate, int invert, int unflip,
                                 void* stream) {
  if (log2c < 1 || log2c > MAX_LOG2C || n_chunks < 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  static bool opted_in = false;   // once a process (one card)
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * (1 << MAX_LOG2C) * static_cast<int>(sizeof(int32_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  int threads = (1 << log2c) / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = 2 * (static_cast<size_t>(1) << log2c) * sizeof(int32_t);
  chunk_kv_kernel<<<n_chunks, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xk), static_cast<const int32_t*>(xv),
      static_cast<int32_t*>(ok), static_cast<int32_t*>(ov), log2c, pad,
      alternate, invert, unflip);
  return static_cast<int>(cudaGetLastError());
}
