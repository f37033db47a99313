// sellp.cu — SELL-P (per-row-sourced plane ELL) SpMV for Hopper (sm_90a),
// K7.
//
// Replaces the TPU kernel libhpc_tpu/ops/sellp.py:_kernel. In the pane
// layout of ops/sellp.py (x3[p, j, l] = x[1024 p + 8 l + j],
// out[8 s + j, l] = y[1024 s + 8 l + j]):
//
//   out[8 s + j, l] = sum over the tiles t of stripe s, in tile-stream order,
//                     of V[t, j, l] * x3[pane[t], (L >> 7) & 7, L & 127],
//                     L = lidx[t, j, l]
//
// Design:
//   - The TPU kernel selects each tile row's x row with an 8-way
//     broadcast-select and then shuffles lanes, because its only fast
//     gather is along lanes. On Hopper it is one load from global memory.
//   - The reference interleaves tiles round-robin across stripes so that
//     consecutive grid steps do not read-modify-write the same VMEM rows.
//     Hopper blocks run in no order, so one block per stripe owns that
//     stripe's 8x128 outputs and walks its tiles
//     tile_order[tile_ptr[s] .. tile_ptr[s+1]) (built on the host by a
//     stable sort on sid: the reference's order within the stripe, the
//     zero padding tiles last in stripe 0). No atomics, each output written
//     once, every stripe written (zeros where it has no tile).
//   - One thread per lane (128 threads) keeps its 8 outputs in registers;
//     value and index rows load as 128 consecutive 4-byte words.
//   - The product is rounded before the add (__fmul_rn), as the
//     reference's V * gx followed by its accumulate.
//
// What bounds it: bytes of the value and index planes (8 KB a tile, read
// once) and the latency of the x load behind each index load. Poisson
// 1024^2 streams about 50 MB, the size of the H100's L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int B = 8;
constexpr int LANE = 128;

__global__ void __launch_bounds__(LANE)
    sellp_kernel(const float* __restrict__ vflat,
                 const int32_t* __restrict__ lidx,
                 const int32_t* __restrict__ pane,
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
    const int t = tile_order[k];
    const int64_t base = static_cast<int64_t>(t) * (B * LANE) + l;
    const float* xp = x3 + static_cast<int64_t>(pane[t]) * (B * LANE);
    int32_t li[B];
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      li[j] = lidx[base + j * LANE];
      v[j] = vflat[base + j * LANE];
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int xi = ((li[j] >> 7) & (B - 1)) * LANE + (li[j] & (LANE - 1));
      acc[j] += __fmul_rn(v[j], __ldg(xp + xi));
    }
  }

  float* o = out + static_cast<int64_t>(s) * (B * LANE) + l;
#pragma unroll
  for (int j = 0; j < B; ++j) o[j * LANE] = acc[j];
}

}  // namespace

extern "C" int sellp_spmv_f32(const void* vflat, const void* lidx,
                              const void* pane, const void* tile_order,
                              const void* tile_ptr, const void* x3, void* out,
                              int n_stripes, void* stream) {
  if (n_stripes > 0) {
    sellp_kernel<<<n_stripes, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vflat), static_cast<const int32_t*>(lidx),
        static_cast<const int32_t*>(pane),
        static_cast<const int32_t*>(tile_order),
        static_cast<const int32_t*>(tile_ptr), static_cast<const float*>(x3),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
