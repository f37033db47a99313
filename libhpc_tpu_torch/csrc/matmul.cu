// matmul.cu — tiled dense matmul for Hopper (sm_90a), K18.
//
// Replaces the TPU kernel libhpc_tpu/ops/matmul.py:_mm_kernel
// (matmul_pallas):
//
//   C = A @ B,   A: (M, K), B: (K, N), C: (M, N), all row-major;
//   sums in float32, C in the operands' dtype
//
// Design:
//   - The TPU kernel walks a (M/TM, N/TN, K/TK) grid whose K axis runs in
//     order and carries the float32 accumulator in VMEM. On Hopper blocks
//     run in no order, so a block owns a whole 128 x 128 tile of C and
//     walks K itself, 8 deep at a time; the accumulator lives in
//     registers: each of 256 threads holds an 8 x 8 sub-tile (64 floats).
//   - Per K step a block stages A[128 x 8] (transposed, rows padded by 4
//     floats so the transposing stores do not collide in one bank) and
//     B[8 x 128] in shared memory, zero-filling what lies past M, N or K
//     (so no operand is padded in device memory), then each thread reads
//     8 values of A and 8 of B as float4s and does 64 FMAs.
//   - float32 operands use FP32 FMAs on the CUDA cores, not TF32: the
//     reference's tolerance (rtol 1e-4 at K = 300-512) needs float32's 24
//     mantissa bits. bfloat16 and float16 operands are widened to float32
//     as they are staged and take the same FMAs; C is rounded once to the
//     operands' dtype (round to nearest even).
//
// What bounds it: the 2*M*N*K operations on the CUDA cores' FP32 rate
// (67 TFLOP/s on an H100 SXM). A half-width input gets no tensor cores
// here, so its bound, at the tensor cores' rate, is far below this time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}
__device__ __forceinline__ void store(float v, __half* o) {
  *o = __float2half(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int bm = blockIdx.y * BM;
  const int bn = blockIdx.x * BN;
  const int tr = tid / (BN / TN);  // thread's row group: rows tr*TM + i
  const int tc = tid % (BN / TN);  // thread's column group: tc*TN + j

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, q = e % BK;
      const int gr = bm + r, gq = k0 + q;
      As[q][r] = (gr < m && gq < k)
                     ? to_f32(a[static_cast<int64_t>(gr) * k + gq]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int q = e / BN, cc = e % BN;
      const int gq = k0 + q, gc = bn + cc;
      Bs[q][cc] = (gq < k && gc < n)
                      ? to_f32(b[static_cast<int64_t>(gq) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      float av[TM], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[q][tr * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[q][tr * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[q][tc * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[q][tc * TN + 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = bm + tr * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = bn + tc * TN + j;
      if (gc < n) store(acc[i][j], c + static_cast<int64_t>(gr) * n + gc);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int gy = (m + BM - 1) / BM;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, gy);
  mm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_f32(const void* a, const void* b, void* c, int m, int n,
                          int k, void* stream) {
  return launch<float>(a, b, c, m, n, k, stream);
}

extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m,
                           int n, int k, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, stream);
}

extern "C" int matmul_f16(const void* a, const void* b, void* c, int m, int n,
                          int k, void* stream) {
  return launch<__half>(a, b, c, m, n, k, stream);
}
