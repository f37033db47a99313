// blur2d.cu — 2-D box sum with a zero halo for Hopper (sm_90a), K19.
//
// Replaces the TPU kernel libhpc_tpu/ops/stencil.py:_blur2d_kernel
// (blur2d_pallas):
//
//   out[y, x] = sum_{dy=-r..r} sum_{dx=-r..r} a[y+dy, x+dx],
//   cells outside a read as zero; a, out: (M, N) float32 row-major
//
// Design:
//   - The TPU kernel DMAs (tile_m + 2r) full padded rows into VMEM and
//     takes cumsum differences along x, then y; its input is a zero-padded
//     copy of a. A full 8192-wide row tile does not fit a block's shared
//     memory, so here a block owns a 64 x 64 output tile and loads its
//     (64 + 2r) x (64 + 2r) window of a, with the cells outside a stored
//     as zero: no padded copy of the input exists.
//   - x pass: for each of the window's 64 + 2r rows and the tile's 64
//     columns, the 2r + 1 terms are added left to right into a second
//     shared array; y pass: each output adds its 2r + 1 x-sums top to
//     bottom. Direct sums in a fixed order, no running sum, so the plain
//     version (blur2d_pallas_torch) adds the same terms in the same order.
//   - A warp's 32 threads touch 32 consecutive words of a row in both
//     passes (no bank conflicts). The shared arrays grow with r: dynamic
//     shared memory, up to r = 64 (192 KB).
//
// What bounds it: the bytes of a read once and of out written once. The
// window's halo is re-read by neighbouring blocks (1.56x the tile at
// r = 8, mostly from L2), and each output costs about 2 * (2r + 1)
// shared-memory reads and adds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int THREADS = 256;
constexpr int MAX_RADIUS = 64;

__global__ void __launch_bounds__(THREADS)
    blur2d_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int m, int n, int r) {
  extern __shared__ float sh[];
  const int wr = TM + 2 * r;   // window rows
  const int wc = TN + 2 * r;   // window columns
  float* win = sh;             // (wr, wc)
  float* bx = sh + wr * wc;    // (wr, TN): x-sums of the window's rows
  const int y0 = blockIdx.y * TM;
  const int x0 = blockIdx.x * TN;
  const int tid = threadIdx.x;

  for (int e = tid; e < wr * wc; e += THREADS) {
    const int i = e / wc, j = e % wc;
    const int gy = y0 - r + i, gx = x0 - r + j;
    win[e] = (gy >= 0 && gy < m && gx >= 0 && gx < n)
                 ? __ldg(a + static_cast<int64_t>(gy) * n + gx) : 0.f;
  }
  __syncthreads();

  for (int e = tid; e < wr * TN; e += THREADS) {
    const int i = e / TN, j = e % TN;
    const float* w = win + i * wc + j;
    float acc = 0.f;
#pragma unroll 4
    for (int d = 0; d <= 2 * r; ++d) acc += w[d];
    bx[e] = acc;
  }
  __syncthreads();

  for (int e = tid; e < TM * TN; e += THREADS) {
    const int i = e / TN, j = e % TN;
    const int gy = y0 + i, gx = x0 + j;
    if (gy >= m || gx >= n) continue;
    const float* c = bx + i * TN + j;
    float acc = 0.f;
#pragma unroll 4
    for (int d = 0; d <= 2 * r; ++d) acc += c[d * TN];
    out[static_cast<int64_t>(gy) * n + gx] = acc;
  }
}

}  // namespace

extern "C" int blur2d_f32(const void* a, void* out, int m, int n, int radius,
                          void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (radius < 0 || radius > MAX_RADIUS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gy = (m + TM - 1) / TM;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int wr = TM + 2 * radius, wc = TN + 2 * radius;
  const size_t smem = (static_cast<size_t>(wr) * wc +
                       static_cast<size_t>(wr) * TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blur2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TN - 1) / TN, gy);
  blur2d_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), m, n, radius);
  return static_cast<int>(cudaGetLastError());
}
