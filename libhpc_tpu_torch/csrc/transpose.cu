// transpose.cu — tiled matrix transpose for Hopper (sm_90a), K17.
//
// Replaces the TPU kernel libhpc_tpu/ops/transpose.py:_transpose_kernel
// (transpose_pallas):
//
//   out[j, i] = x[i, j],   x: (M, N) row-major, out: (N, M) row-major
//
// Design: libHPC's own kernel_transpose (lib/gpu/util/include/
// cudaUtils.cuh:9-37), which the reference's docstring cites. A block of
// 32 x 8 threads owns a 32 x 32 tile: it reads the tile row by row
// (consecutive threads, consecutive columns: coalesced), keeps it in shared
// memory with one column of padding (a column read then touches 32
// different banks), and writes the transposed tile row by row (coalesced
// again). The TPU kernel moved 1024 x 1024 VMEM blocks and padded x to
// whole blocks first; here the ragged last row and column of tiles are
// masked in the kernel, so nothing is padded or copied. Elements move as
// words of their size (1, 2, 4 or 8 bytes), so every such dtype takes the
// same kernel: float32 and int32 as 32-bit words, bfloat16 as 16-bit ones.
//
// What bounds it: the bytes of x read once and of out written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

template <typename W>
__global__ void __launch_bounds__(TILE * ROWS)
    transpose_kernel(const W* __restrict__ x, W* __restrict__ out, int64_t m,
                     int64_t n, int64_t tiles_n) {
  __shared__ W tile[TILE][TILE + 1];
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t / tiles_n) * TILE;  // first row of x in this tile
  const int64_t c0 = (t % tiles_n) * TILE;  // first column of x
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int k = ty; k < TILE; k += ROWS) {
    const int64_t r = r0 + k, c = c0 + tx;
    if (r < m && c < n) tile[k][tx] = x[r * n + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = ty; k < TILE; k += ROWS) {
    const int64_t r = c0 + k, c = r0 + tx;  // row and column of out
    if (r < n && c < m) out[r * m + c] = tile[tx][k];
  }
}

template <typename W>
int launch(const void* x, void* out, int m, int n, void* stream) {
  const int64_t tiles_m = (static_cast<int64_t>(m) + TILE - 1) / TILE;
  const int64_t tiles_n = (static_cast<int64_t>(n) + TILE - 1) / TILE;
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<W><<<static_cast<unsigned>(blocks), dim3(TILE, ROWS), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<W*>(out), m, n, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int transpose_words(const void* x, void* out, int m, int n,
                               int word_bytes, void* stream) {
  switch (word_bytes) {
    case 1: return launch<uint8_t>(x, out, m, n, stream);
    case 2: return launch<uint16_t>(x, out, m, n, stream);
    case 4: return launch<uint32_t>(x, out, m, n, stream);
    case 8: return launch<uint64_t>(x, out, m, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
