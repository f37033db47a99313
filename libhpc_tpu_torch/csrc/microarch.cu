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
//   - K21b. Hopper's bulk copies (cp.async.bulk, TMA without a tensor
//     map): a stage of a ring in shared memory holds `stage_rows` output
//     rows, a whole number of gathers where R rows fit (one bulk copy of
//     R * 512 bytes a gather, all completing on the stage's mbarrier),
//     else part of one gather (a copy a piece); the stage goes out as one
//     bulk store (cp.async.bulk.global.shared::cta.bulk_group), since a
//     stage's output rows are contiguous. A persistent grid (as many
//     one-warp blocks as fit the card) walks the stages; in each block
//     lane 0 announces the stage's bytes (expect_tx: exactly its rows *
//     512), the lanes each issue one piece's copy (its index loaded one
//     stage ahead), lane 0 waits on the stage's barrier and issues the
//     store, so `stages` - 1 stages of loads stay in flight beside the
//     stores. A stage is refilled only after its store has read it
//     (cp.async.bulk.wait_group.read). No thread touches a stage through
//     the generic proxy. The loads mark table rows evict_last in the L2
//     and the stores mark the output evict_first, so that a repeated
//     gather finds its row in the L2 more often. Indices are clamped into [0, n_table) so a bad
//     one cannot leave the table. What bounds it: the bytes, each gathered
//     row read and written once (a random gather over a table past the
//     L2 re-reads a repeated row from device memory).
//   - K21c. One warp a row, 4 values a thread as a float4: the rotate by
//     one lane is one __shfl_sync of the neighbour's last value (the
//     counterpart of pltpu.roll); the other three come from the thread's
//     own registers.
//   - K21d. The same layout: a thread's float4 is two adjacent pairs, so no
//     value crosses threads.
//   K21c and K21d use fminf / fmaxf: the probes take NaN-free inputs.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_async.cuh"

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

constexpr int ROW_BYTES = LANE * 4;
constexpr int DMA_MAX_STAGES = 8;
constexpr int DMA_MAX_PIECES = 32;      // copies a stage: one a lane

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The copy of one piece of a stage: `rows` rows of gather k from row r0
// of that gather, landing at row `at` of the stage.
struct Piece {
  int64_t src;   // first table row
  int rows;
  int at;
};

// lane l's piece of stage group g (rows [q0, q0 + n) of the output);
// rows == 0 where the stage has fewer pieces than lanes
__device__ __forceinline__ Piece piece_of(const int* __restrict__ idx,
                                          int n_table, int r, int64_t q0,
                                          int n, int lane) {
  const int64_t k = q0 / r + lane;
  const int64_t lo = max64(q0, k * r);
  const int64_t hi = min64(q0 + n, (k + 1) * r);
  if (lo >= hi) return Piece{0, 0, 0};
  const int src = min(max(__ldg(idx + k), 0), n_table - 1);
  return Piece{int64_t(src) * r + (lo - k * r), static_cast<int>(hi - lo),
               static_cast<int>(lo - q0)};
}

// L2 policies: table rows stay (a repeated gather may find its row there),
// the output streams through
__device__ __forceinline__ uint64_t l2_policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src),
      "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(dst), "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

__global__ void __launch_bounds__(32)
    dma_gather_kernel(const int* __restrict__ idx,
                      const char* __restrict__ table, int n_table, int r,
                      int64_t total_rows, int stage_rows, int stages,
                      char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[DMA_MAX_STAGES];
  const int lane = threadIdx.x;
  const int64_t n_groups = (total_rows + stage_rows - 1) / stage_rows;
  // this block's stage groups: blockIdx.x + i gridDim.x, i < n_mine
  const int64_t n_mine =
      blockIdx.x < n_groups ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t stage_bytes = uint32_t(stage_rows) * ROW_BYTES;
  const uint64_t keep = l2_policy_keep();
  const uint64_t stream = l2_policy_stream();
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto group_rows = [&](int64_t i, int64_t* q0) {
    *q0 = (blockIdx.x + i * gridDim.x) * int64_t{stage_rows};
    return static_cast<int>(min64(stage_rows, total_rows - *q0));
  };
  // group i into stage i % stages: lane 0 announces its bytes, each lane
  // copies its piece
  auto load = [&](int64_t i, const Piece& p, int n) {
    const int s = static_cast<int>(i % stages);
    const uint32_t bar = smem_u32(&full[s]);
    if (lane == 0) mbar_expect_tx(bar, uint32_t(n) * ROW_BYTES);
    __syncwarp();
    if (p.rows > 0)
      bulk_load(ring0 + s * stage_bytes + uint32_t(p.at) * ROW_BYTES,
                table + p.src * ROW_BYTES, uint32_t(p.rows) * ROW_BYTES, bar,
                keep);
  };

  const int64_t first = min64(stages, n_mine);
  for (int64_t i = 0; i < first; ++i) {
    int64_t q0;
    const int n = group_rows(i, &q0);
    load(i, piece_of(idx, n_table, r, q0, n, lane), n);
  }
  // the piece of the next group to load, its index read a stage ahead
  int64_t q_next = 0;
  int n_next = 0;
  Piece next{0, 0, 0};
  if (stages < n_mine) {
    n_next = group_rows(stages, &q_next);
    next = piece_of(idx, n_table, r, q_next, n_next, lane);
  }
  for (int64_t i = 0; i < n_mine; ++i) {
    const int s = static_cast<int>(i % stages);
    int64_t q0;
    const int n = group_rows(i, &q0);
    if (lane == 0) {
      mbar_wait(smem_u32(&full[s]), uint32_t(i / stages) & 1);
      bulk_store(out + q0 * ROW_BYTES, ring0 + s * stage_bytes,
                 uint32_t(n) * ROW_BYTES, stream);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    // refill the stage of group i - 1 with group i - 1 + stages, once its
    // store (every group's but the one just issued) has read it
    const int64_t g = i - 1 + stages;
    if (i >= 1 && g < n_mine) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
      load(g, next, n_next);
      if (g + 1 < n_mine) {
        n_next = group_rows(g + 1, &q_next);
        next = piece_of(idx, n_table, r, q_next, n_next, lane);
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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
// 128) f32; a ring of `stages` stages of `stage_rows` rows: stage_rows a
// multiple of r of at most 32 gathers, or less than r.
extern "C" int dma_gather_f32(const void* idx, const void* table, void* out,
                              int n_table, int n_gather, int r,
                              int stage_rows, int stages, void* stream) {
  if (n_gather <= 0 || r <= 0) return 0;
  if (n_table <= 0 || stage_rows < 1 || stages < 2 ||
      stages > DMA_MAX_STAGES ||
      (stage_rows >= r && (stage_rows % r || stage_rows / r > DMA_MAX_PIECES)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stages * stage_rows * ROW_BYTES;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      dma_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dma_gather_kernel, 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = int64_t(n_gather) * r;
  const int64_t groups = (total + stage_rows - 1) / stage_rows;
  const int blocks =
      static_cast<int>(std::min<int64_t>(groups, int64_t(sms) * per_sm));
  dma_gather_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const char*>(table), n_table,
      r, total, stage_rows, stages, static_cast<char*>(out));
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
