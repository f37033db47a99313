// overlap_chip.cu — the memory/compute overlap sweep for Hopper (sm_90a),
// K20.
//
// Replaces the TPU kernel libhpc_tpu/bench/overlap_chip.py:_kernel
// (_sweep_step): x is (steps * 2048, 128) float32, read as `steps` blocks
// of 2048 rows (1 MB). For every element v of a block
//
//   acc = v;  repeat w times: acc = acc * 1.000001f + v
//
// and the block's (8, 128) output row j, lane l is the sum of acc over the
// block's rows r with r % 8 == j. Output: (steps * 8, 128) float32.
//
// Design:
//   - The TPU streams the blocks HBM -> VMEM through its auto double-
//     buffered grid pipeline. Here one CUDA block of 256 threads owns one
//     1 MB block and reads it with plain coalesced 16-byte loads; memory
//     latency is hidden by the other resident blocks (up to 8 an SM) and
//     by UNROLL independent loads a thread. An explicit cp.async / TMA
//     double buffer is later work.
//   - Thread t owns output row j = t / 32 and lanes 4 * (t % 32) .. + 3, so
//     a warp reads one 512-byte row, and the 8 warps read 8 consecutive
//     rows. Each thread walks the 256 row groups of its block in order
//     and keeps its four output sums in registers: no shared memory, no
//     atomics, the same result in every run.
//   - The chain is written with fmaf and a float literal: a double literal
//     would turn it into FP64 operations, another unit at a fraction of the
//     rate. The build has no fast-math. The loop over w runs outside the
//     4 * UNROLL independent chains of a thread, so each round issues 16
//     FMAs for one loop step.
//   - Every row is folded into the output, so no round is dead code.
//
// What bounds it: the bytes of x (read once) below the ridge, the FMAs
// (2 w flops an element) above it; on an H100 the ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop a byte) lies near w = 40.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 2048;   // rows of one 1 MB block
constexpr int LANE = 128;
constexpr int THREADS = 256;  // 8 output rows x 32 float4 columns
constexpr int GROUPS = ROWS / 8;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
    sweep_kernel(const float4* __restrict__ x, int w,
                 float4* __restrict__ out) {
  const int j = threadIdx.x / 32;
  const int c = threadIdx.x % 32;
  const float4* blk = x + static_cast<int64_t>(blockIdx.x) * ROWS * (LANE / 4);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < GROUPS; i0 += UNROLL) {
    float4 v[UNROLL], acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = __ldg(blk + ((i0 + u) * 8 + j) * (LANE / 4) + c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = v[u];
    for (int k = 0; k < w; ++k) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        acc[u].x = fmaf(acc[u].x, 1.000001f, v[u].x);
        acc[u].y = fmaf(acc[u].y, 1.000001f, v[u].y);
        acc[u].z = fmaf(acc[u].z, 1.000001f, v[u].z);
        acc[u].w = fmaf(acc[u].w, 1.000001f, v[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      sum.x += acc[u].x;
      sum.y += acc[u].y;
      sum.z += acc[u].z;
      sum.w += acc[u].w;
    }
  }
  out[(static_cast<int64_t>(blockIdx.x) * 8 + j) * (LANE / 4) + c] = sum;
}

}  // namespace

// x: (steps * 2048, 128) float32, 16-byte aligned; out: (steps * 8, 128).
extern "C" int overlap_sweep_f32(const void* x, void* out, int steps, int w,
                                 void* stream) {
  if (steps <= 0) return 0;
  if (w < 0) return static_cast<int>(cudaErrorInvalidValue);
  sweep_kernel<<<steps, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), w, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
