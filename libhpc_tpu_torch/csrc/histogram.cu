// histogram.cu — n_bins histogram of int32 for Hopper (sm_90a), K15.
//
// Replaces the TPU kernel libhpc_tpu/ops/histogram.py:_hist_kernel:
//
//   out[b] = #{ i : x[i] == b },  0 <= b < n_bins
//
// Values outside [0, n_bins) are not counted (the reference pads with the
// out-of-range bin n_bins and its one-hot compare never matches them).
//
// Design:
//   - The TPU kernel compares each (8,128) tile with all n_bins at once
//     (one-hot, summed on the VPU) and carries the sum in VMEM along its
//     sequential grid. On Hopper the blocks run in no order; each block
//     keeps its own histogram in shared memory, adds with shared-memory
//     atomics over a grid-stride slice of x, then adds each nonzero bin
//     into the zeroed global output with one atomicAdd (libHPC's
//     kernel_local_histogram: block-local counts, then one global add).
//   - Integer adds commute, so the counts are exact whatever the order.
//   - Each thread issues four independent loads per step to keep enough
//     bytes in flight; loads of a warp are consecutive 4-byte words.
//
// What bounds it: the 4 bytes read per element, and the shared-memory
// atomics when many elements of a warp hit one bin (few distinct values).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr int MAX_BLOCKS = 1056;   // 8 per SM on 132 SMs

__global__ void __launch_bounds__(THREADS)
    hist_kernel(const int32_t* __restrict__ x, int64_t n, int n_bins,
                int32_t* __restrict__ out) {
  extern __shared__ int32_t sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
    int32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (static_cast<uint32_t>(v[u]) < static_cast<uint32_t>(n_bins))
        atomicAdd(&sh[v[u]], 1);
    }
  }
  for (; i < n; i += stride) {
    const int32_t v = __ldg(x + i);
    if (static_cast<uint32_t>(v) < static_cast<uint32_t>(n_bins))
      atomicAdd(&sh[v], 1);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    if (sh[b] != 0) atomicAdd(out + b, sh[b]);
  }
}

}  // namespace

extern "C" int histogram_i32(const void* x, void* out, int n, int n_bins,
                             void* stream) {
  if (n <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (static_cast<int64_t>(n) + THREADS * UNROLL - 1) /
                   (THREADS * UNROLL);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  hist_kernel<<<static_cast<int>(blocks), THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), n, n_bins, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
