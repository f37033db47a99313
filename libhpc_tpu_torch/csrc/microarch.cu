// microarch.cu — the micro-architecture probes for Hopper (sm_90a):
// K21a (lane shuffle), K21b (row gather), K21c and K21d (one compare-
// exchange pass, two pairings).
//
// Replaces the TPU kernels of libhpc_tpu/bench/microarch.py:
//
//   K21a _lane_shuffle_call's kernel: tab (S, 128) f32, idx (n_tiles * S,
//        128) int32 in [0, 128):
//          out[g * S + r, l] = tab[r, idx[g * S + r, l]]
//        (take_along_axis on axis 1: a row reads only its own table row).
//   K21b _dma_gather_call's kernel: idx (n_gather,) int32 in [0, n_table),
//        table (n_table * R, 128) f32:
//          out[k * R + q, :] = table[idx[k] * R + q, :],  q < R
//        (the TPU keeps G DMAs of R rows in flight and waits once).
//   K21c _cmpex_roll_call's kernel: x (rows, 128) f32, y = roll(x, 1) on
//        the lanes (y[:, l] = x[:, l - 1], y[:, 0] = x[:, 127]);
//          out[:, l] = l even ? min(x, y) : max(x, y)
//        so even lane 2k pairs with lane 2k - 1 and lane 0 with lane 127.
//   K21d _cmpex_reshape_call's kernel: lanes paired (2k, 2k + 1):
//          out[:, 2k] = min(x[:, 2k], x[:, 2k + 1]), out[:, 2k + 1] = max
//        K21c and K21d agree on the odd lanes only, as on the TPU.
//
// Design and what bounds each (all are bound by bytes: table, indices,
// input and output each cross device memory once):
//   - K21a. The TPU holds the whole table in VMEM; 1024 rows (512 KB, the
//     bench's default) pass the 227 KB of shared memory a block may have.
//     A block here owns 8 table rows, stages them in shared memory (4 KB)
//     and serves them to SHUF_TILES tiles: thread t takes row t / 32 and
//     lanes 4 (t % 32) .. + 3, loads 4 indices as one int4, reads 4 shared
//     words at lane idx & 127 (never past its row), stores one float4. A
//     warp's 32 random lanes of one row fall in 32 banks with a few
//     conflicts. A register variant (__shfl_sync from the warp holding
//     the row) is later work.
//   - K21b. cp.async 16-byte copies into shared memory, all of a stage
//     committed as one group and waited on once (the counterpart of G
//     DMAs and one semaphore wait), then coalesced 16-byte stores. A block
//     owns one stage of min(G * R, 64) rows (32 KB): the TPU's G * R rows
//     (1 MB at G = 256) do not fit, and the other resident blocks (up to
//     7 an SM) keep more rows in flight. A warp copies one 512-byte row.
//     Indices are clamped into [0, n_table) so a bad one cannot leave the
//     table. TMA bulk copies are later work.
//   - K21c. One warp a row, 4 values a thread as a float4: the rotate by
//     one lane is one __shfl_sync of the neighbour's last value (the
//     counterpart of pltpu.roll); the other three come from the thread's
//     own registers.
//   - K21d. The same layout: a thread's float4 is two adjacent pairs, so no
//     value crosses threads.
//   K21c and K21d use fminf / fmaxf: the probes take NaN-free inputs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// ---- K21a ------------------------------------------------------------------

constexpr int SHUF_ROWS = 8;   // table rows a block owns
constexpr int SHUF_TILES = 16;  // tiles a block serves from them

__global__ void __launch_bounds__(THREADS)
    lane_shuffle_kernel(const float* __restrict__ tab,
                        const int4* __restrict__ idx, int s, int n_tiles,
                        float4* __restrict__ out) {
  __shared__ float rows[SHUF_ROWS][LANE];
  const int r0 = blockIdx.x * SHUF_ROWS;
  for (int e = threadIdx.x; e < SHUF_ROWS * LANE; e += THREADS) {
    const int r = r0 + e / LANE;
    rows[e / LANE][e % LANE] = r < s ? __ldg(tab + int64_t(r) * LANE +
                                              e % LANE)
                                     : 0.f;
  }
  __syncthreads();
  const int rr = threadIdx.x / 32;
  const int c = threadIdx.x % 32;
  if (r0 + rr >= s) return;
  const float* row = rows[rr];
  const int g0 = blockIdx.y * SHUF_TILES;
  const int g1 = min(g0 + SHUF_TILES, n_tiles);
  for (int g = g0; g < g1; ++g) {
    const int64_t o = (int64_t(g) * s + r0 + rr) * (LANE / 4) + c;
    const int4 i = __ldg(idx + o);
    out[o] = make_float4(row[i.x & (LANE - 1)], row[i.y & (LANE - 1)],
                         row[i.z & (LANE - 1)], row[i.w & (LANE - 1)]);
  }
}

// ---- K21b ------------------------------------------------------------------

constexpr int STAGE_ROWS = 64;          // 32 KB of shared memory
constexpr int CHUNKS = LANE * 4 / 16;   // 16-byte chunks in a row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(THREADS)
    dma_gather_kernel(const int* __restrict__ idx,
                      const float4* __restrict__ table, int n_table, int r,
                      int64_t total_rows, int stage_rows,
                      float4* __restrict__ out) {
  __shared__ float4 stage[STAGE_ROWS * CHUNKS];
  const int64_t q0 = int64_t(blockIdx.x) * stage_rows;
  const int64_t left = total_rows - q0;
  const int rows = left < stage_rows ? static_cast<int>(left) : stage_rows;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += THREADS) {
    const int64_t q = q0 + e / CHUNKS;
    const int k = static_cast<int>(q / r);
    const int src = min(max(__ldg(idx + k), 0), n_table - 1);
    cp_async16(stage + e,
               table + (int64_t(src) * r + q % r) * CHUNKS + e % CHUNKS);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * CHUNKS; e += THREADS)
    out[q0 * CHUNKS + e] = stage[e];
}

// ---- K21c, K21d ------------------------------------------------------------

constexpr int CMPEX_ROWS = 4;   // rows a warp takes, loads issued together

template <bool ROLL>
__global__ void __launch_bounds__(THREADS)
    cmpex_kernel(const float4* __restrict__ x, int64_t n_rows,
                 float4* __restrict__ out) {
  const int c = threadIdx.x % 32;
  const int64_t row0 =
      (int64_t(blockIdx.x) * WARPS + threadIdx.x / 32) * CMPEX_ROWS;
  float4 v[CMPEX_ROWS];
#pragma unroll
  for (int u = 0; u < CMPEX_ROWS; ++u)
    if (row0 + u < n_rows) v[u] = __ldg(x + (row0 + u) * (LANE / 4) + c);
#pragma unroll
  for (int u = 0; u < CMPEX_ROWS; ++u) {
    // every lane of the warp takes part in the shuffle, row or no row
    float4 a = row0 + u < n_rows ? v[u] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o;
    if (ROLL) {
      // y[4c] = x[4c - 1], the last value of the previous thread (thread 0
      // takes lane 127 from thread 31)
      const float prev = __shfl_sync(0xffffffffu, a.w, (c + 31) & 31);
      o = make_float4(fminf(a.x, prev), fmaxf(a.y, a.x), fminf(a.z, a.y),
                      fmaxf(a.w, a.z));
    } else {
      o = make_float4(fminf(a.x, a.y), fmaxf(a.x, a.y), fminf(a.z, a.w),
                      fmaxf(a.z, a.w));
    }
    if (row0 + u < n_rows) out[(row0 + u) * (LANE / 4) + c] = o;
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// tab: (s, 128) f32; idx: (n_tiles * s, 128) int32; out like idx, f32.
extern "C" int lane_shuffle_f32(const void* tab, const void* idx, void* out,
                                int s, int n_tiles, void* stream) {
  if (s <= 0 || n_tiles <= 0) return 0;
  const dim3 grid((s + SHUF_ROWS - 1) / SHUF_ROWS,
                  (n_tiles + SHUF_TILES - 1) / SHUF_TILES);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  lane_shuffle_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int4*>(idx), s,
      n_tiles, static_cast<float4*>(out));
  return last_error();
}

// idx: (n_gather,) int32; table: (n_table * r, 128) f32; out: (n_gather * r,
// 128) f32; stage_rows in [1, 64].
extern "C" int dma_gather_f32(const void* idx, const void* table, void* out,
                              int n_table, int n_gather, int r,
                              int stage_rows, void* stream) {
  if (n_gather <= 0 || r <= 0) return 0;
  if (n_table <= 0 || stage_rows < 1 || stage_rows > STAGE_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = int64_t(n_gather) * r;
  const int64_t blocks = (total + stage_rows - 1) / stage_rows;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  dma_gather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float4*>(table),
      n_table, r, total, stage_rows, static_cast<float4*>(out));
  return last_error();
}

template <bool ROLL>
static int cmpex_launch(const void* x, void* out, int rows, void* stream) {
  if (rows <= 0) return 0;
  const int per_block = WARPS * CMPEX_ROWS;
  cmpex_kernel<ROLL><<<(rows + per_block - 1) / per_block, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), rows, static_cast<float4*>(out));
  return last_error();
}

// x, out: (rows, 128) f32.
extern "C" int cmpex_roll_f32(const void* x, void* out, int rows,
                              void* stream) {
  return cmpex_launch<true>(x, out, rows, stream);
}

extern "C" int cmpex_reshape_f32(const void* x, void* out, int rows,
                                 void* stream) {
  return cmpex_launch<false>(x, out, rows, stream);
}
