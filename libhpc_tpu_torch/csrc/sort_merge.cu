// sort_merge.cu — the merge levels of the u32 sort for Hopper (sm_90a):
// the merge-path split search and one merge-path merge, K9, K10 and K12.
//
// Replaces the TPU kernels libhpc_tpu/ops/sort_pallas.py:_merge_kernel
// (one merge level, K9), :_pair_merge_kernel (the fold of two segment
// buffers, K10) and libhpc_tpu/ops/sort_pallas_kv.py:_merge_kernel_kv (the
// same with a 32-bit payload beside every key, K12), and the split search
// that feeds them (sort_pallas.py:_level_scalars / _pair_scalars, plain
// jnp on the TPU).
//
// split_search_kernel: one thread a window of W = 2^log2w outputs runs the
// search of ops/sort_merge.py:_level_scalars (a level: runs of R = 2^log2r,
// A ascending at base, B descending at base + R, pair p of the level
// descending iff (p odd) != invert) or _pair_scalars (A of LA ascending in
// one buffer, B of LB descending in another, one direction): the same
// fixed count of steps (log2r + 1, or min(LA, LB).bit_length() + 1), the
// same predicate at the same addresses, and the same clamp
// split = min(lo, hi0), so its seven int32 arrays (rowA, dA, rowB, dB,
// kA, kB, desc) equal the plain version's exactly. An eighth, take[w],
// is the number of outputs of window w that come from A: the next
// window's split minus this one's, or LA - split for the last window of a
// run pair. A block's threads pass their splits to their neighbours
// through shared memory; the last thread of a block searches its window's
// end itself.
//
// merge_path_kernel<KV>: window w of the output is the W smallest
// candidates past the split, in the NOT-conjugated domain of a descending
// window (m = desc ? -1 : 0), ascending, written at out + pad + w W, ^ m
// (and ^ 0x80000000 if unflip). In that domain A's candidates X and B's
// candidates Y both ascend:
//
//   asc:  X_j = A[sA + j],          Y_j = B[sB + W - 1 - j]
//   desc: X_j = ~A[sA + W - 1 - j], Y_j = ~B[sB + j]
//
// and, the split being the merge path's, the window is exactly the merge
// of X_0 .. X_{take-1} with Y_0 .. Y_{W-take-1}, ties taking X (the
// search's A-first rule, so the merge is stable).
//
// What bounds it: a level reads every element once and writes it once,
// 8 bytes an element with keys alone and 16 with payloads, over 3.35 TB/s:
// 1.28 ms a level of 2^29 keys. The TPU's bitonic halver read 2W
// candidates to write W (12 / 20 bytes an element) and sorted them with
// log2 W barrier-separated stages of compare-exchanges, because the TPU
// has no scalar merge. Design:
//   - W / IPT threads a block, IPT = 16 outputs each. With both splits
//     known a window reads exactly its take keys of A and W - take of B:
//     two contiguous ranges, copied in storage order as whole 16-byte
//     chunks (cp.async.cg; up to 3 elements of slack at either end of a
//     range, in the buffers' padding), so B, stored descending, and a
//     descending window's A are read forward and indexed backward. No
//     candidate past a run is merged, so a key equal to the +inf fill
//     never meets a masked candidate.
//   - A persistent grid (as many blocks as fit the card) walks the
//     windows; each block keeps two buffers in shared memory, so the next
//     window's copies fly while this one merges.
//   - Each thread finds its start on the merge path by a binary search in
//     shared memory (log2 W steps), then merges IPT outputs serially in
//     registers; a payload is read from shared memory beside the key taken.
//   - The outputs go back through shared memory, 16-byte chunks XOR-
//     swizzled in rows of 8 chunks (a thread's four 16-byte writes and a
//     warp's coalesced reads are each free of bank conflicts), and out as
//     16-byte stores: pad + w W is a multiple of 4.
//   - W = 2^12 (ops/sort_merge.py:LOG2W_KERNEL): 256 threads, two buffers
//     of 16 KB (32 KB with payloads). On an H100 2^11 and 2^12 ran alike
//     and 2^13 slower with payloads (chip_smoke.py's merge window sweep);
//     the reference's 2^17 never fit a block. The kernel takes 2^1..2^13.
//   - Offsets are 64-bit.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int IPT = 16;              // outputs a merge thread takes
constexpr int MAX_LOG2W = 13;
constexpr int MAX_W = 1 << MAX_LOG2W;
constexpr int MAX_THREADS = MAX_W / IPT;
constexpr int SPLIT_THREADS = 256;
constexpr int PLAN_ROWS = 8;         // rowA dA rowB dB kA kB desc take
constexpr int LANE = 128;
constexpr int32_t FLIP = INT32_MIN;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// ---- the split search ------------------------------------------------------

struct SplitArgs {
  int64_t pad;    // flat offset of the data in both buffers
  int64_t la;     // A's run length
  int64_t lb;     // B's run length
  int64_t span;   // outputs of a run pair: 2R, or LA + LB
  int64_t b_off;  // B's run after A's in the same buffer (R), or 0
  int log2w;
  int steps;      // fixed count of binary-search steps
  int alt;        // 1: the direction alternates by pair (a level)
  int flag;       // invert (a level) or desc_out (a pair merge)
};

// the merge-path split of output o of the pair at base: the number of A
// elements among the o first outputs, ties taking A; exactly
// _level_scalars' / _pair_scalars' search, clamp included
__device__ __forceinline__ int64_t split_at(const int32_t* __restrict__ a,
                                            const int32_t* __restrict__ b,
                                            int64_t o, bool desc,
                                            const SplitArgs& s) {
  int64_t lo = max64(o - s.lb, 0);
  const int64_t hi0 = min64(o, s.la);
  int64_t hi = hi0;
  for (int step = 0; step < s.steps; ++step) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t kb = o - 1 - mid;
    const int64_t kbc = min64(max64(kb, 0), s.lb - 1);
    // asc: A[mid] <= B_rank(kb); desc: A_top(mid) >= B_top(kb)
    const int32_t va = desc ? a[s.la - 1 - mid] : a[mid];
    const int32_t vb = desc ? b[kbc] : b[s.lb - 1 - kbc];
    const bool pred = kb >= 0 && (desc ? va >= vb : va <= vb);
    if (pred) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min64(lo, hi0);
}

__device__ __forceinline__ int64_t floor_div(int64_t x, int64_t d) {
  return x >= 0 ? x / d : -((-x + d - 1) / d);
}

__global__ void __launch_bounds__(SPLIT_THREADS)
    split_search_kernel(const int32_t* __restrict__ srcA,
                        const int32_t* __restrict__ srcB,
                        int32_t* __restrict__ plan, int nw, SplitArgs s) {
  __shared__ int64_t splits[SPLIT_THREADS];
  const int w = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const int64_t W = int64_t{1} << s.log2w;
  const int64_t out_pos = static_cast<int64_t>(w) * W;
  const int64_t pair = out_pos / s.span;
  const int64_t base = pair * s.span;
  const int64_t o = out_pos - base;
  const bool desc = ((pair & s.alt) != 0) != (s.flag != 0);
  const int32_t* a = srcA + s.pad + base;
  const int32_t* b = srcB + s.pad + base + s.b_off;
  const int64_t split = w < nw ? split_at(a, b, o, desc, s) : 0;
  splits[threadIdx.x] = split;
  __syncthreads();
  if (w >= nw) return;

  int64_t end;
  if (o + W == s.span) {
    end = s.la;                               // the pair's last window
  } else if (threadIdx.x + 1 < SPLIT_THREADS) {
    end = splits[threadIdx.x + 1];            // the next window's start
  } else {
    end = split_at(a, b, o + W, desc, s);
  }
  const int64_t rho = o - split;
  const int64_t sA = s.pad + base + (desc ? s.la - split - W : split);
  const int64_t sB =
      s.pad + base + s.b_off + (desc ? rho : s.lb - rho - W);
  const int64_t rowA = floor_div(sA, 8 * LANE) * 8;
  const int64_t rowB = floor_div(sB, 8 * LANE) * 8;
  const int32_t out[PLAN_ROWS] = {
      static_cast<int32_t>(rowA),
      static_cast<int32_t>(sA - rowA * LANE),
      static_cast<int32_t>(rowB),
      static_cast<int32_t>(sB - rowB * LANE),
      static_cast<int32_t>(max64(split + W - s.la, 0)),
      static_cast<int32_t>(max64(rho + W - s.lb, 0)),
      desc ? 1 : 0,
      static_cast<int32_t>(end - split)};
#pragma unroll
  for (int r = 0; r < PLAN_ROWS; ++r)
    plan[static_cast<int64_t>(r) * nw + w] = out[r];
}

// ---- the merge -------------------------------------------------------------

// elements of one buffer: a window's W candidates in whole 16-byte chunks
// of their two ranges (up to 16 of slack), or its W outputs
__host__ __device__ __forceinline__ int buffer_elems(int W) {
  return (W > IPT ? W : IPT) + 16;
}

// element p of a window staged for 16-byte stores: chunk c = p / 4 lies at
// chunk c ^ ((c / 8) % 8) of its row of 8 chunks
__device__ __forceinline__ int swz(int p) {
  const int c = p >> 2;
  return ((c ^ ((c >> 3) & 7)) << 2) | (p & 3);
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A window's candidates in shared memory. X's take (= na) elements and
// Y's W - na lie in the sources as two contiguous ranges; each is copied
// in storage order as whole 16-byte chunks (up to 3 elements of slack at
// either end), X's at 0 and Y's after, so that X_j = buf[xb + xd j] and
// Y_j = buf[yb - xd j], both ascending in the window's domain.
struct Window {
  int64_t xa;   // first element of X's chunks in the source
  int64_t ya;   // first element of Y's chunks
  int xchunks;  // 16-byte chunks of X's range, then of Y's
  int ychunks;
  int xb;       // X_0's and Y_0's place in the buffer
  int yb;
  int xd;       // 1, or -1 in a descending window
  int na;       // outputs from X (A)
  int32_t m;    // 0, or -1 (NOT) in a descending window
};

__device__ __forceinline__ Window window_of(const int32_t* __restrict__ plan,
                                            int64_t nw, int64_t w, int W) {
  const int64_t sA = static_cast<int64_t>(plan[w]) * LANE + plan[nw + w];
  const int64_t sB =
      static_cast<int64_t>(plan[2 * nw + w]) * LANE + plan[3 * nw + w];
  const bool desc = plan[6 * nw + w] != 0;
  const int na = plan[7 * nw + w];
  const int nb = W - na;
  // asc:  X_j = A[sA + j],           Y_j = B[sB + W - 1 - j]
  // desc: X_j = ~A[sA + W - 1 - j],  Y_j = ~B[sB + j]
  const int64_t xlo = desc ? sA + W - na : sA;
  const int64_t ylo = desc ? sB : sB + W - nb;
  Window win;
  win.xa = xlo & ~int64_t{3};
  win.ya = ylo & ~int64_t{3};
  win.xchunks = na ? static_cast<int>(((xlo + na + 3) >> 2) - (xlo >> 2)) : 0;
  win.ychunks = nb ? static_cast<int>(((ylo + nb + 3) >> 2) - (ylo >> 2)) : 0;
  const int yoff = 4 * win.xchunks;
  win.xb = static_cast<int>(xlo - win.xa) + (desc ? na - 1 : 0);
  win.yb = yoff + static_cast<int>(ylo - win.ya) + (desc ? 0 : nb - 1);
  win.xd = desc ? -1 : 1;
  win.na = na;
  win.m = desc ? -1 : 0;
  return win;
}

// the copies of a window's chunks (keys, and payloads beside them)
template <bool KV>
__device__ __forceinline__ void load_window(
    const Window& win, const int32_t* __restrict__ srcAk,
    const int32_t* __restrict__ srcAv, const int32_t* __restrict__ srcBk,
    const int32_t* __restrict__ srcBv, int32_t* sk, int32_t* sv, int T,
    int t) {
  const int n = win.xchunks + win.ychunks;
  for (int c = t; c < n; c += T) {
    const bool from_x = c < win.xchunks;
    const int64_t g = from_x ? win.xa + 4 * c
                             : win.ya + 4 * (c - win.xchunks);
    cp_async16(sk + 4 * c, (from_x ? srcAk : srcBk) + g);
    if (KV) cp_async16(sv + 4 * c, (from_x ? srcAv : srcBv) + g);
  }
}

template <bool KV>
__global__ void __launch_bounds__(MAX_THREADS)
    merge_path_kernel(const int32_t* __restrict__ srcAk,
                      const int32_t* __restrict__ srcAv,
                      const int32_t* __restrict__ srcBk,
                      const int32_t* __restrict__ srcBv,
                      const int32_t* __restrict__ plan, int nw, int log2w,
                      int64_t pad, int unflip, int32_t* __restrict__ outk,
                      int32_t* __restrict__ outv) {
  extern __shared__ int4 smem[];
  const int W = 1 << log2w;
  const int cap = buffer_elems(W);
  const int T = blockDim.x;
  const int t = threadIdx.x;
  // two buffers, each keys then (KV) payloads
  int32_t* const base = reinterpret_cast<int32_t*>(smem);
  const int stride = (KV ? 2 : 1) * cap;

  int64_t w = blockIdx.x;
  if (w < nw)
    load_window<KV>(window_of(plan, nw, w, W), srcAk, srcAv, srcBk, srcBv,
                    base, base + cap, T, t);
  cp_async_commit();
  for (int it = 0; w < nw; ++it, w += gridDim.x) {
    int32_t* sk = base + (it & 1) * stride;
    int32_t* sv = sk + cap;
    // the next window's copies fly while this one merges
    const int64_t wn = w + gridDim.x;
    if (wn < nw) {
      int32_t* nk = base + ((it + 1) & 1) * stride;
      load_window<KV>(window_of(plan, nw, wn, W), srcAk, srcAv, srcBk,
                      srcBv, nk, nk + cap, T, t);
    }
    cp_async_commit();
    const Window win = window_of(plan, nw, w, W);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();

    const int na = win.na;
    const int nb = W - na;
    const int32_t m = win.m;
    const int xb = win.xb;
    const int yb = win.yb;
    const int xd = win.xd;
    // this thread's first output d: how many of the d first come from X
    const int d = min(t * IPT, W);
    int lo = max(0, d - nb);
    int hi = min(d, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((sk[xb + xd * mid] ^ m) <= (sk[yb - xd * (d - 1 - mid)] ^ m)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // walk X and Y by their places in the buffer
    int px = xb + xd * lo;
    int py = yb - xd * (d - lo);
    int i = lo;
    int j = d - lo;
    int32_t kx = i < na ? sk[px] ^ m : 0;
    int32_t ky = j < nb ? sk[py] ^ m : 0;
    int32_t rk[IPT];
    int32_t rv[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const bool take_x = j >= nb || (i < na && kx <= ky);
      rk[k] = take_x ? kx : ky;
      if (KV && d + k < W) rv[k] = sv[take_x ? px : py];
      if (take_x) {
        ++i;
        px += xd;
        kx = i < na ? sk[px] ^ m : 0;
      } else {
        ++j;
        py -= xd;
        ky = j < nb ? sk[py] ^ m : 0;
      }
    }
    __syncthreads();

    const int32_t omask = unflip ? (m ^ FLIP) : m;
    if (W >= IPT) {
#pragma unroll
      for (int q = 0; q < IPT / 4; ++q) {
        const int p = d + 4 * q;
        reinterpret_cast<int4*>(sk)[swz(p) >> 2] =
            make_int4(rk[4 * q] ^ omask, rk[4 * q + 1] ^ omask,
                      rk[4 * q + 2] ^ omask, rk[4 * q + 3] ^ omask);
        if (KV)
          reinterpret_cast<int4*>(sv)[swz(p) >> 2] = make_int4(
              rv[4 * q], rv[4 * q + 1], rv[4 * q + 2], rv[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        if (k < W) {
          sk[swz(k)] = rk[k] ^ omask;
          if (KV) sv[swz(k)] = rv[k];
        }
      }
    }
    __syncthreads();

    const int64_t o0 = pad + w * W;
    if (((pad | W) & 3) == 0) {
      int4* dk = reinterpret_cast<int4*>(outk + o0);
      int4* dv = reinterpret_cast<int4*>(outv + o0);
      for (int c = t; c < W / 4; c += T) {
        const int s = swz(4 * c) >> 2;
        dk[c] = reinterpret_cast<const int4*>(sk)[s];
        if (KV) dv[c] = reinterpret_cast<const int4*>(sv)[s];
      }
    } else {
      for (int p = t; p < W; p += T) {
        outk[o0 + p] = sk[swz(p)];
        if (KV) outv[o0 + p] = sv[swz(p)];
      }
    }
    // this buffer takes the window after next
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

int split_launch(const void* srcA, const void* srcB, void* plan, int nw,
                 const SplitArgs& s, void* stream) {
  if (nw == 0) return 0;
  split_search_kernel<<<(nw + SPLIT_THREADS - 1) / SPLIT_THREADS,
                        SPLIT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(srcA), static_cast<const int32_t*>(srcB),
      static_cast<int32_t*>(plan), nw, s);
  return static_cast<int>(cudaGetLastError());
}

template <bool KV>
int merge_launch(const void* srcAk, const void* srcAv, const void* srcBk,
                 const void* srcBv, const void* plan, void* outk, void* outv,
                 int nw, int log2w, int pad, int unflip, void* stream) {
  if (log2w < 1 || log2w > MAX_LOG2W || nw < 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nw == 0) return 0;
  const int W = 1 << log2w;
  const int threads = W >= IPT ? W / IPT : 1;
  const int smem = 2 * (KV ? 2 : 1) * buffer_elems(W) * 4;
  // two windows of 2^13 keys and payloads pass the 48 KB a block gets
  // unasked: raise the limit once for each device (before any graph
  // capture); a persistent grid of as many blocks as fit the card
  static uint64_t raised = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !(raised >> dev & 1))) {
    e = cudaFuncSetAttribute(merge_path_kernel<KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * (KV ? 2 : 1) * buffer_elems(MAX_W) * 4);
    if (e == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_path_kernel<KV>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::min(nw, sms * std::max(per_sm, 1));
  merge_path_kernel<KV><<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(srcAk), static_cast<const int32_t*>(srcAv),
      static_cast<const int32_t*>(srcBk), static_cast<const int32_t*>(srcBv),
      static_cast<const int32_t*>(plan), nw, log2w, pad, unflip,
      static_cast<int32_t*>(outk), static_cast<int32_t*>(outv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan: (8, nw) int32. A level of buf: runs of 2^log2r at flat pad.
extern "C" int sort_split_level_i32(const void* buf, void* plan,
                                    int n_windows, int log2w, int pad,
                                    int log2r, int invert, void* stream) {
  if (log2w < 1 || log2w > log2r + 1 || log2r > 30 || n_windows < 0 ||
      pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t r = int64_t{1} << log2r;
  const SplitArgs s{pad, r, r, 2 * r, r, log2w, log2r + 1, 1, invert};
  return split_launch(buf, buf, plan, n_windows, s, stream);
}

// A: la keys ascending at flat pad of bufA; B: lb descending at pad of bufB.
extern "C" int sort_split_pair_i32(const void* bufA, const void* bufB,
                                   void* plan, int n_windows, int log2w,
                                   int pad, int la, int lb, int steps,
                                   int desc_out, void* stream) {
  if (log2w < 1 || log2w > 30 || la < 1 || lb < 1 || n_windows < 0 ||
      pad < 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs s{pad, la, lb, int64_t{la} + lb, 0, log2w, steps, 0,
                    desc_out};
  return split_launch(bufA, bufB, plan, n_windows, s, stream);
}

extern "C" int sort_merge_i32(const void* srcA, const void* srcB,
                              const void* plan, void* out, int n_windows,
                              int log2w, int pad, int unflip, void* stream) {
  return merge_launch<false>(srcA, nullptr, srcB, nullptr, plan, out,
                             nullptr, n_windows, log2w, pad, unflip, stream);
}

extern "C" int sort_merge_kv_i32(const void* srcAk, const void* srcAv,
                                 const void* srcBk, const void* srcBv,
                                 const void* plan, void* outk, void* outv,
                                 int n_windows, int log2w, int pad,
                                 int unflip, void* stream) {
  return merge_launch<true>(srcAk, srcAv, srcBk, srcBv, plan, outk, outv,
                            n_windows, log2w, pad, unflip, stream);
}
