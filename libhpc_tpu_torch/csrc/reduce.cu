// reduce.cu — row sums of a 2-D array for Hopper (sm_90a), K16.
//
// Replaces the TPU kernel libhpc_tpu/ops/reduce.py:_row_sum_kernel
// (row_sum_pallas):
//
//   out[i] = sum_j x[i, j],   x: (M, N) row-major, out: (M,) in x's dtype
//
// float32 and bfloat16 are summed in float32; int32 is summed with
// wrapping 32-bit adds (as jnp.sum in int32).
//
// Design:
//   - The TPU kernel pads x to (8k, 128k) and reduces (8, N) row tiles in
//     VMEM. Here one warp owns one row and a block of 256 threads owns 8
//     rows; nothing is padded, and a row of any length is read in place.
//   - Each lane adds the elements j = lane, lane + 32, ... of its row in a
//     fixed order (16-byte loads when the row start is 16-byte aligned and
//     N fills whole 16-byte words, then the ragged tail), then the warp
//     folds its 32 partial sums with a fixed xor-shuffle butterfly. There
//     are no atomics, so a result is the same in every run.
//
// What bounds it: the bytes of x, read once (M*N*sizeof(T)); the output is
// M words. The loop keeps four 16-byte loads of a lane in flight.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ uint32_t widen(int32_t v) {
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ void narrow(float a, float* o) { *o = a; }
__device__ __forceinline__ void narrow(float a, __nv_bfloat16* o) {
  *o = __float2bfloat16(a);
}
__device__ __forceinline__ void narrow(uint32_t a, int32_t* o) {
  *o = static_cast<int32_t>(a);
}

// T: element type; A: accumulator (float for floats, uint32_t for int32,
// whose adds wrap).
template <typename T, typename A, bool VEC>
__global__ void __launch_bounds__(THREADS)
    row_sum_kernel(const T* __restrict__ x, int64_t m, int64_t n,
                   T* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const T* r = x + row * n;
  A acc = 0;
  int64_t tail = 0;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int64_t nv = n / V;
    const uint4* rv = reinterpret_cast<const uint4*>(r);
#pragma unroll 4
    for (int64_t j = lane; j < nv; j += 32) {
      const uint4 w = __ldg(rv + j);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int u = 0; u < V; ++u) acc += widen(e[u]);
    }
    tail = nv * V;
  }
  for (int64_t j = tail + lane; j < n; j += 32) acc += widen(__ldg(r + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) narrow(acc, out + row);
}

template <typename T, typename A>
int launch(const void* x, void* out, int m, int n, void* stream) {
  if (m <= 0) return 0;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (static_cast<int64_t>(n) * sizeof(T)) % 16 == 0;
  const int blocks = (m + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    row_sum_kernel<T, A, true><<<blocks, THREADS, 0, s>>>(xp, m, n, op);
  else
    row_sum_kernel<T, A, false><<<blocks, THREADS, 0, s>>>(xp, m, n, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int row_sum_f32(const void* x, void* out, int m, int n,
                           void* stream) {
  return launch<float, float>(x, out, m, n, stream);
}

extern "C" int row_sum_bf16(const void* x, void* out, int m, int n,
                            void* stream) {
  return launch<__nv_bfloat16, float>(x, out, m, n, stream);
}

extern "C" int row_sum_i32(const void* x, void* out, int m, int n,
                           void* stream) {
  return launch<int32_t, uint32_t>(x, out, m, n, stream);
}
