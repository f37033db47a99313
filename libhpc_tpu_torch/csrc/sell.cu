// sell.cu — SELL (striped scalar-ELL) SpMV for Hopper (sm_90a), K6.
//
// Replaces the TPU kernel libhpc_tpu/ops/ell_pallas.py:_kernel. In the pane
// layout of ops/spmv_sell.py (x3[p, j, l] = x[1024 p + 8 l + j],
// out[8 s + j, l] = y[1024 s + 8 l + j]):
//
//   out[8 s + j, l] = sum over the tiles t of stripe s, in tile-stream order,
//                     of V[t, j, l] * x3[c >> 10, c & 7, (c >> 3) & 127],
//                     c = C[t, j, l] (an absolute column)
//
// Design:
//   - The TPU kernel gathers x with W*8 static sublane rotations, a lane
//     gather per rotation and a select, because the TPU has no gather along
//     two axes. On Hopper that whole construction is one load from global
//     memory (x3 is small and stays in L2).
//   - The TPU kernel zeroes its VMEM output at grid step 0 and adds every
//     tile into it in grid order. Hopper blocks run in no order, so one
//     block per stripe owns that stripe's 8x128 outputs and walks its tiles
//     tile_order[tile_ptr[s] .. tile_ptr[s+1]) (built on the host by a
//     stable sort on sid: a stripe's tiles in stream order, the zero
//     padding tiles last in stripe 0). No atomics, the reference's
//     summation order, each output written once; the guard stripes are
//     zeroed by the wrapper.
//   - One thread per lane (128 threads) keeps its 8 outputs in registers;
//     every value and column row load is 128 consecutive 4-byte words.
//   - The product is rounded before the add (__fmul_rn), as the
//     reference's V * gx followed by its accumulate.
//
// What bounds it: bytes of the value and column planes (8 KB a tile, read
// once) and the latency of the dependent x load behind each column load.
// Poisson 1024^2 streams about 42-50 MB, the size of the H100's L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int B = 8;
constexpr int LANE = 128;

__global__ void __launch_bounds__(LANE)
    sell_kernel(const float* __restrict__ vflat,
                const int32_t* __restrict__ cflat,
                const int32_t* __restrict__ tile_order,
                const int32_t* __restrict__ tile_ptr,
                const float* __restrict__ x3, float* __restrict__ out) {
  const int s = blockIdx.x;
  const int l = threadIdx.x;

  float acc[B];
#pragma unroll
  for (int j = 0; j < B; ++j) acc[j] = 0.0f;

  const int k_end = tile_ptr[s + 1];
  for (int k = tile_ptr[s]; k < k_end; ++k) {
    const int64_t base = static_cast<int64_t>(tile_order[k]) * (B * LANE) + l;
    int32_t c[B];
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      c[j] = cflat[base + j * LANE];
      v[j] = vflat[base + j * LANE];
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int64_t xi = static_cast<int64_t>(c[j] >> 10) * (B * LANE)
                         + (c[j] & (B - 1)) * LANE + ((c[j] >> 3) & (LANE - 1));
      acc[j] += __fmul_rn(v[j], __ldg(x3 + xi));
    }
  }

  float* o = out + static_cast<int64_t>(s) * (B * LANE) + l;
#pragma unroll
  for (int j = 0; j < B; ++j) o[j * LANE] = acc[j];
}

}  // namespace

extern "C" int sell_spmv_f32(const void* vflat, const void* cflat,
                             const void* tile_order, const void* tile_ptr,
                             const void* x3, void* out, int n_stripes,
                             void* stream) {
  if (n_stripes > 0) {
    sell_kernel<<<n_stripes, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vflat), static_cast<const int32_t*>(cflat),
        static_cast<const int32_t*>(tile_order),
        static_cast<const int32_t*>(tile_ptr), static_cast<const float*>(x3),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
