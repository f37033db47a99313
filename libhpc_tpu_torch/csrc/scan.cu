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
// Design: the TPU grid runs in order, so the reference carries the running
// sum from one grid step to the next in SMEM. Hopper blocks run in no
// order, so this is a reduce-then-scan over blocks of BLOCK = 4096
// elements (256 threads x 16):
//   1. reduce_kernel: the sum of every block         -> sums[nb]
//   2. the same scan, recursively, over sums[nb] in place (one level
//      for up to 2^24 elements, two for up to 2^36)
//   3. scan_kernel: every block scanned in shared memory, plus sums[b].
// Each thread adds 16 contiguous elements serially; thread totals are
// scanned with warp shuffles, warp totals by the first warp. K13 adds in
// FP32 on the CUDA cores: a TF32 tensor-core product (the analogue of the
// reference's matmul) would keep 10 of the 23 mantissa bits. The summation
// order differs from the reference's, so f32 results agree to rounding, not
// bit for bit. Element offsets are 64-bit.
//
// What bounds it: bytes. x is read twice (steps 1 and 3) and out written
// once, 12 bytes an element against the 8 a one-pass scan needs; the block
// sums are 1/4096 of that.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int BLOCK = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int padded(int l) { return l + (l >> 5); }

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const T* __restrict__ x, int64_t n, T* __restrict__ sums) {
  __shared__ T warp_tot[WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCK;
  T acc = T(0);
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * THREADS + threadIdx.x;
    if (i < n) acc += x[i];
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    T v = threadIdx.x < WARPS ? warp_tot[threadIdx.x] : T(0);
    v = warp_sum(v);
    if (threadIdx.x == 0) sums[blockIdx.x] = v;
  }
}

// x and out may be the same array: a block reads all of its elements into
// shared memory before it writes any.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* x, int64_t n, T* out, const T* offsets) {
  __shared__ T tile[BLOCK + BLOCK / 32];
  __shared__ T warp_ex[WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int k = 0; k < ITEMS; ++k) {
    const int l = k * THREADS + threadIdx.x;
    const int64_t i = base + l;
    tile[padded(l)] = i < n ? x[i] : T(0);
  }
  __syncthreads();

  T v[ITEMS];
  T run = T(0);
  for (int j = 0; j < ITEMS; ++j) {
    v[j] = run;
    run += tile[padded(threadIdx.x * ITEMS + j)];
  }
  T incl, excl;
  warp_scan(run, incl, excl);
  if (lane == 31) warp_ex[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T wi, we;
    warp_scan(lane < WARPS ? warp_ex[lane] : T(0), wi, we);
    if (lane < WARPS) warp_ex[lane] = we;
  }
  __syncthreads();
  const T block_off = offsets ? offsets[blockIdx.x] : T(0);
  const T off = block_off + warp_ex[warp] + excl;
  for (int j = 0; j < ITEMS; ++j)
    tile[padded(threadIdx.x * ITEMS + j)] = off + v[j];
  __syncthreads();

  for (int k = 0; k < ITEMS; ++k) {
    const int l = k * THREADS + threadIdx.x;
    const int64_t i = base + l;
    if (i < n) out[i] = tile[padded(l)];
  }
}

// scratch holds the block sums of every level: ceil(n / BLOCK) elements,
// then those of the level above, while a level has more than BLOCK
// (ops/scan.py:scan_scratch_len computes the total).
template <typename T>
int scan_levels(const T* x, int64_t n, T* out, T* scratch,
                cudaStream_t stream) {
  if (n <= BLOCK) {
    scan_kernel<T><<<1, THREADS, 0, stream>>>(x, n, out, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  reduce_kernel<T><<<static_cast<unsigned>(nb), THREADS, 0, stream>>>(
      x, n, scratch);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = scan_levels<T>(scratch, nb, scratch, scratch + nb, stream);
  if (rc) return rc;
  scan_kernel<T><<<static_cast<unsigned>(nb), THREADS, 0, stream>>>(
      x, n, out, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scan_exclusive_f32(const void* x, void* out, void* scratch,
                                  int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return scan_levels<float>(static_cast<const float*>(x), n,
                            static_cast<float*>(out),
                            static_cast<float*>(scratch),
                            static_cast<cudaStream_t>(stream));
}

extern "C" int scan_exclusive_i32(const void* x, void* out, void* scratch,
                                  int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return scan_levels<uint32_t>(static_cast<const uint32_t*>(x), n,
                               static_cast<uint32_t*>(out),
                               static_cast<uint32_t*>(scratch),
                               static_cast<cudaStream_t>(stream));
}
