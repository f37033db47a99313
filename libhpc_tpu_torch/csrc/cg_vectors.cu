// cg_vectors.cu — the vector work of one CG iteration in three kernels, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the port's counterpart of what XLA fuses
// inside the reference's lax.while_loop (libhpc_tpu/ops/solver.py:cg): the
// two dots, the three vector updates and the scalar divides between the
// matvecs of ops/solver.py:cg. Eager PyTorch runs them as ~12 aten launches
// and 23 vector passes an iteration (a dot writes its product and reads it
// back; each update takes two passes).
//
// The three kernels, in the order of an iteration (s = the per-solve state,
// s[RS] = r.r, s[PQ] = p.Ap, s[BETA]):
//
//   cg_dot_pAp    s[PQ] = sum p Ap                      reads p, Ap
//   cg_update_xr  alpha = s[RS] / s[PQ];                reads x, r, p, Ap
//                 x += alpha p;  r -= alpha Ap;         writes x, r
//                 rs_new = sum r r (on the r written);
//                 s[BETA] = rs_new / s[RS]; s[RS] = rs_new
//   cg_update_p   p = r + s[BETA] p                     reads r, p; writes p
//
// alpha and beta never leave the device, and no product is written.
//
// What bounds it: bytes. 11 vector passes an iteration (2 + 6 + 3); at
// 2^24 float32 entries that is 738 MB, 0.220 ms at 3.35 TB/s.
//
// Design:
//   - A grid-stride loop over 16-byte words (float4 / double2) where every
//     pointer of the launch is 16-byte aligned, else over single elements;
//     the ragged tail (n mod the word's width) is taken element by element.
//     The grid is sized from n: one block per 256 words, capped at a few
//     blocks per SM (kBlocksPerSm x the SM count) and at the workspace's
//     length, so one launch shape serves 10^4 to 10^8 entries.
//   - Dots: each thread sums its elements in order, a warp folds its 32
//     sums with a fixed xor-shuffle butterfly, warp 0's lane 0 adds the
//     warps' sums in order, and each block writes one partial sum. The last
//     block to finish (it learns so from an atomic ticket, which it resets
//     for the next launch) adds the partials in a fixed order and stores the
//     total. No floating-point atomics: for a given n, card and alignment a
//     result is the same in every run.
//   - cg_update_xr reads s[RS] before its block takes its ticket, so the
//     last block may overwrite it: every other block has read it by then.
//   - Sums are taken in the vectors' dtype (float32 or float64), as the
//     plain version takes them; only their order differs.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

// slots of the per-solve state (ops/cg_vectors.py RS, PQ, BETA)
constexpr int kRs = 0;
constexpr int kPq = 1;
constexpr int kBeta = 2;

// elements of T in a 16-byte word
template <typename T>
constexpr int kWidth = 16 / sizeof(T);

template <typename T>
union Word {
  uint4 u;
  T e[kWidth<T>];
};

template <typename T>
__device__ __forceinline__ Word<T> load_word(const T* p, int64_t i) {
  Word<T> w;
  w.u = reinterpret_cast<const uint4*>(p)[i];
  return w;
}

template <typename T>
__device__ __forceinline__ void store_word(T* p, int64_t i, const Word<T>& w) {
  reinterpret_cast<uint4*>(p)[i] = w.u;
}

// The block's sum of v, in thread 0 (other threads get 0): a fixed
// butterfly in each warp, then the warps' sums in order.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
  }
  __syncthreads();  // warp_sums may be written again by the next call
  return s;
}

// Writes this block's partial sum; in the last block to finish, returns
// true with the sum of every block's partial, in block order, in thread 0.
// The last block resets the ticket for the next launch.
template <typename T>
__device__ bool grid_sum(T block_total, T* partials, unsigned* ticket,
                         T* total) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T v = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads)
    v += __ldcg(partials + b);
  *total = block_sum(v);
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    cg_dot_pAp(const T* __restrict__ p, const T* __restrict__ q, int64_t n,
               T* state, T* partials, unsigned* ticket) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = 0;
  int64_t tail = 0;
  if (kVec) {
    constexpr int V = kWidth<T>;
    const int64_t nw = n / V;
#pragma unroll 2
    for (int64_t i = t; i < nw; i += stride) {
      const Word<T> a = load_word(p, i), b = load_word(q, i);
#pragma unroll
      for (int u = 0; u < V; ++u) acc += a.e[u] * b.e[u];
    }
    tail = nw * V;
  }
  for (int64_t i = tail + t; i < n; i += stride) acc += p[i] * q[i];
  T total;
  if (grid_sum(block_sum(acc), partials, ticket, &total) &&
      threadIdx.x == 0)
    state[kPq] = total;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    cg_update_xr(T* __restrict__ x, T* __restrict__ r,
                 const T* __restrict__ p, const T* __restrict__ q, int64_t n,
                 T* state, T* partials, unsigned* ticket) {
  const T rs = __ldcg(state + kRs);
  const T alpha = rs / __ldcg(state + kPq);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = 0;
  int64_t tail = 0;
  if (kVec) {
    constexpr int V = kWidth<T>;
    const int64_t nw = n / V;
#pragma unroll 2
    for (int64_t i = t; i < nw; i += stride) {
      Word<T> xw = load_word(x, i), rw = load_word(r, i);
      const Word<T> pw = load_word(p, i), qw = load_word(q, i);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        xw.e[u] += alpha * pw.e[u];
        rw.e[u] -= alpha * qw.e[u];
        acc += rw.e[u] * rw.e[u];
      }
      store_word(x, i, xw);
      store_word(r, i, rw);
    }
    tail = nw * V;
  }
  for (int64_t i = tail + t; i < n; i += stride) {
    x[i] += alpha * p[i];
    const T ri = r[i] - alpha * q[i];
    r[i] = ri;
    acc += ri * ri;
  }
  T rs_new;
  if (grid_sum(block_sum(acc), partials, ticket, &rs_new) &&
      threadIdx.x == 0) {
    state[kBeta] = rs_new / rs;
    state[kRs] = rs_new;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    cg_update_p(T* __restrict__ p, const T* __restrict__ r, int64_t n,
                const T* state) {
  const T beta = __ldcg(state + kBeta);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    constexpr int V = kWidth<T>;
    const int64_t nw = n / V;
#pragma unroll 2
    for (int64_t i = t; i < nw; i += stride) {
      Word<T> pw = load_word(p, i);
      const Word<T> rw = load_word(r, i);
#pragma unroll
      for (int u = 0; u < V; ++u) pw.e[u] = rw.e[u] + beta * pw.e[u];
      store_word(p, i, pw);
    }
    tail = nw * V;
  }
  for (int64_t i = tail + t; i < n; i += stride) p[i] = r[i] + beta * p[i];
}

bool aligned(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// Blocks of a launch over n elements: one per kThreads words (elements
// without 16-byte words), at least 1, at most kBlocksPerSm per SM and
// max_blocks (the workspace's partial sums).
template <typename T>
int grid_for(int64_t n, bool vec, int max_blocks, int* blocks) {
  static int sm_count[kMaxDevices] = {};  // per device, read once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    e = cudaDeviceGetAttribute(&sm_count[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t units = vec ? n / kWidth<T> : n;
  const int64_t cap = std::min<int64_t>(
      static_cast<int64_t>(sm_count[dev]) * kBlocksPerSm, max_blocks);
  *blocks = static_cast<int>(
      std::max<int64_t>(1, std::min((units + kThreads - 1) / kThreads, cap)));
  return 0;
}

template <typename T>
int launch_dot(const void* p, const void* q, void* state, void* partials,
               void* ticket, int n, int max_blocks, void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(p) && aligned(q);
  int blocks = 0;
  const int rc = grid_for<T>(n, vec, max_blocks, &blocks);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pp = static_cast<const T*>(p);
  const T* qp = static_cast<const T*>(q);
  T* st = static_cast<T*>(state);
  T* part = static_cast<T*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  if (vec)
    cg_dot_pAp<T, true><<<blocks, kThreads, 0, s>>>(pp, qp, n, st, part, tk);
  else
    cg_dot_pAp<T, false><<<blocks, kThreads, 0, s>>>(pp, qp, n, st, part, tk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_xr(void* x, void* r, const void* p, const void* q, void* state,
              void* partials, void* ticket, int n, int max_blocks,
              void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(x) && aligned(r) && aligned(p) && aligned(q);
  int blocks = 0;
  const int rc = grid_for<T>(n, vec, max_blocks, &blocks);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* xp = static_cast<T*>(x);
  T* rp = static_cast<T*>(r);
  const T* pp = static_cast<const T*>(p);
  const T* qp = static_cast<const T*>(q);
  T* st = static_cast<T*>(state);
  T* part = static_cast<T*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  if (vec)
    cg_update_xr<T, true><<<blocks, kThreads, 0, s>>>(xp, rp, pp, qp, n, st,
                                                       part, tk);
  else
    cg_update_xr<T, false><<<blocks, kThreads, 0, s>>>(xp, rp, pp, qp, n, st,
                                                        part, tk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(void* p, const void* r, const void* state, int n,
             int max_blocks, void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(p) && aligned(r);
  int blocks = 0;
  const int rc = grid_for<T>(n, vec, max_blocks, &blocks);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* pp = static_cast<T*>(p);
  const T* rp = static_cast<const T*>(r);
  const T* st = static_cast<const T*>(state);
  if (vec)
    cg_update_p<T, true><<<blocks, kThreads, 0, s>>>(pp, rp, n, st);
  else
    cg_update_p<T, false><<<blocks, kThreads, 0, s>>>(pp, rp, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// state: the per-solve scalars (RS, PQ, BETA) in the vectors' dtype;
// partials: max_blocks words of that dtype; ticket: one uint32, zero
// before the first launch (each reduction leaves it zero).
#define CG_VECTORS_ENTRIES(SUFFIX, T)                                        \
  extern "C" int cg_dot_pAp_##SUFFIX(const void* p, const void* q,           \
                                     void* state, void* partials,            \
                                     void* ticket, int n, int max_blocks,    \
                                     void* stream) {                         \
    return launch_dot<T>(p, q, state, partials, ticket, n, max_blocks,       \
                         stream);                                            \
  }                                                                          \
  extern "C" int cg_update_xr_##SUFFIX(                                      \
      void* x, void* r, const void* p, const void* q, void* state,           \
      void* partials, void* ticket, int n, int max_blocks, void* stream) {   \
    return launch_xr<T>(x, r, p, q, state, partials, ticket, n, max_blocks,  \
                        stream);                                             \
  }                                                                          \
  extern "C" int cg_update_p_##SUFFIX(void* p, const void* r,                \
                                      const void* state, int n,              \
                                      int max_blocks, void* stream) {        \
    return launch_p<T>(p, r, state, n, max_blocks, stream);                  \
  }

CG_VECTORS_ENTRIES(f32, float)
CG_VECTORS_ENTRIES(f64, double)
