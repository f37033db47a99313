// matmul.cu — tiled dense matmul for Hopper (sm_90a), K18.
//
// Replaces the TPU kernel libhpc_tpu/ops/matmul.py:_mm_kernel
// (matmul_pallas):
//
//   C = A @ B,   A: (M, K), B: (K, N), C: (M, N), all row-major;
//   sums in float32, C in the operands' dtype
//
// The TPU kernel walks a (M/TM, N/TN, K/TK) grid whose K axis runs in
// order and carries the float32 accumulator in VMEM. On Hopper blocks run
// in no order, so a block owns a whole tile of C, walks K itself and keeps
// the accumulator in registers. Two kernels:
//
// bfloat16 and float16: wgmma_kernel, on the tensor cores.
//   - The wrapper hands over B^T (N, K), made by K17, so that A and B^T
//     are both K-major and share one recipe: a TMA box of 128 rows x 64
//     values (128 bytes, one 128-byte swizzle row), and one wgmma
//     shared-memory descriptor (start >> 4, LBO 1 (unread), SBO 1024 >> 4
//     = 8 rows of 128 B, layout B128, no transpose). K is padded by the
//     wrapper to a multiple of 8 (16-byte rows for TMA); M and N are not:
//     TMA zero-fills a box that runs past the tensor, and the epilogue
//     masks its stores.
//   - A ring of STAGES stages of (A 16 KB + B^T 16 KB) in dynamic shared
//     memory, aligned by hand to 1 KB (the swizzle repeats every 1 KB).
//     Each stage has a full and an empty mbarrier. A producer warpgroup
//     (one thread of it issues) waits for a stage to be empty, sets the
//     full barrier to expect the whole boxes' bytes (TMA counts a box in
//     full where it zero-fills) and issues the two TMA loads. Two consumer
//     warpgroups each own 64 rows of C: per stage they wait on its full
//     barrier, issue four wgmma.m64n128k16 (one a k16 slice: the
//     descriptors advance 32 bytes), keep one group in flight and release
//     the stage before on its empty barrier (lane 0 of each warp arrives).
//   - Blocks take tiles in bands of GROUP_M tile rows, column by column,
//     so that the blocks in flight share their A and B^T tiles in the L2.
//   - Epilogue: each thread's 64 float32 sums (the m64nNk16 D fragment:
//     warp w, lane l, d[4j + 2h + e] is row 16w + l/4 + 8h, column
//     8j + 2(l%4) + e) are rounded once to nearest even and stored two a
//     word, masked at M and N.
// float32: fma_kernel, FP32 FMAs on the CUDA cores, never TF32: the
//   reference's tolerance (rtol 1e-4 at K = 300-512) needs float32's 24
//   mantissa bits. Each output is one FMA chain over k in ascending order.
//   What bounds it: the 2*M*N*K operations at the FP32 FMA rate, 67
//   TFLOP/s on an H100 SXM; the FMA pipe must issue every cycle, so loads,
//   barriers and the fill of the card have to hide behind it.
//   - The wrapper hands over A^T (K, M), made by K17, and B (K, N), with M
//     and N padded with zeros to multiples of 4 (ops/matmul.py:
//     fma_operands): both are read along their rows, so a stage is FMA_BK
//     rows of contiguous floats that 16-byte cp.async.cg copies put into
//     shared memory already k-major, as the outer products read them; no
//     transpose in the kernel. K is not padded: a copy past K has
//     src-size 0 and fills zeros.
//   - A ring of FMA_STAGES = 3 stages of (A^T FMA_BK x BM + B FMA_BK x BN),
//     48 KB at 128 x 128, with cp.async groups: the copies of step
//     q + 2 are in flight while step q's FMAs run, and one __syncthreads()
//     a K step (FMA_BK = 16: 1024 FMAs a thread a barrier at 128 x 128).
//   - 256 threads a block, each owning (BM/64) x (BN/64) sub-tiles of
//     4 x 4 outputs (8 x 8 at 128 x 128): a warp's fragment reads are
//     conflict-free 16-byte loads of 4 and 8 distinct words, double-buffered
//     in registers (row kk + 1 loads while row kk's FMAs run); C is stored
//     in 16-byte vectors where N is a multiple of 4, masked at M and N.
//   - Tiles that fill the card: 128 x 128 tiles need two resident blocks
//     on each of the 132 SMs to keep the FMA pipes busy. Where they give
//     fewer tiles than the card has SMs (under half its block slots, e.g.
//     64 at 1024^2), the host picks 64 x 64 tiles of the same template
//     instead (256 at 1024^2, four resident an SM; ops/matmul.py:fma_tile).
//     No split-K: it would add a pass and split each output's chain.
//   - Tiles are taken in bands of GROUP_M tile rows, as wgmma_kernel's.
//
// What bounds both: the 2*M*N*K operations, at the tensor cores' dense
// rate for bf16/f16 (989 TFLOP/s on an H100 SXM) and at the CUDA cores'
// FP32 rate for float32 (67 TFLOP/s).

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

// ---- bfloat16 / float16: wgmma fed by a TMA ring ---------------------------

constexpr int WM = 128;                          // rows of C a block
constexpr int WN = 128;                          // columns of C a block
constexpr int WK = 64;                           // K a stage: 128 bytes
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);  // + the producer's
constexpr int TILE_A_BYTES = WM * WK * 2;        // 16 KB
constexpr int TILE_B_BYTES = WN * WK * 2;        // 16 KB
constexpr int STAGE_BYTES = TILE_A_BYTES + TILE_B_BYTES;
constexpr int WG_SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
constexpr int GROUP_M = 8;                       // tile rows in a band
// consumers release a stage only after issuing the next one's wgmma
static_assert(STAGES >= 2, "a ring of one stage deadlocks");
// a barrier wait that polls this long (about 10 s at the card's clock)
// waits for bytes that never come: trap rather than hang the card
constexpr long long HANG_CYCLES = 20000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed (a fresh
// barrier counts its phase before as complete: parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) {
      t0 = now;
    } else if (now - t0 > HANG_CYCLES) {
      __trap();
    }
  }
}

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory at dst;
// completion is reported to bar as bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row atoms (8 x 128 B) lie 1 KB apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define K18_ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define K18_ACC_OPERANDS                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), both from shared memory,
// K-major (transpose immediates 0), scale-d 1.
#define K18_WGMMA(TYPE)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE \
               " " K18_ACC_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"            \
               : K18_ACC_OPERANDS                                            \
               : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64n128k16<__nv_bfloat16>(
    float (&d)[64], uint64_t da, uint64_t db) {
  K18_WGMMA("bf16");
}

template <>
__device__ __forceinline__ void wgmma_m64n128k16<__half>(float (&d)[64],
                                                         uint64_t da,
                                                         uint64_t db) {
  K18_WGMMA("f16");
}

#undef K18_WGMMA
#undef K18_ACC_OPERANDS
#undef K18_ACC_REGS

__device__ __forceinline__ void store2(float v0, float v1, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float v0, float v1, __half* p) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}
__device__ __forceinline__ void store1(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float v, __half* p) {
  *p = __float2half_rn(v);
}

// C = A @ B from the tensor maps of A (M, K) and B^T (N, K); one 128 x 128
// tile of C a block; k a multiple of 8.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_bt,
                 T* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  // this block's tile: bands of GROUP_M tile rows, walked column by column
  const int tiles_m = (m + WM - 1) / WM;
  const int tiles_n = (n + WN - 1) / WN;
  const int band = GROUP_M * tiles_n;
  const int first = (static_cast<int>(blockIdx.x) / band) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_band = static_cast<int>(blockIdx.x) % band;
  const int tm = first + in_band % rows;
  const int tn = in_band / rows;
  const int steps = (k + WK - 1) / WK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues
    if (threadIdx.x == CONSUMERS * 128) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t dst = ring + s * STAGE_BYTES;
        tma_load(dst, &map_a, i * WK, tm * WM, bar);
        tma_load(dst + TILE_A_BYTES, &map_bt, i * WK, tn * WN, bar);
      }
    }
    return;
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const bool arrives = threadIdx.x % 32 == 0;
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
    __syncwarp();  // the wgmma instructions below are .aligned
    const uint32_t a = ring + s * STAGE_BYTES + wg * (TILE_A_BYTES / 2);
    const uint32_t b = ring + s * STAGE_BYTES + TILE_A_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_m64n128k16<T>(d, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the group of step i - 1 is done with its stage: release it
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (i > 0 && arrives) mbar_arrive(smem_u32(&empty[(i - 1) % STAGES]));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);

  const int t = threadIdx.x % 128;
  const int row0 = tm * WM + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = tn * WN + 2 * (t % 4);
  const bool pairs = n % 2 == 0;  // two columns a 4-byte word
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m || col >= n) continue;
      T* p = c + static_cast<int64_t>(row) * n + col;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs) {
        store2(v0, v1, p);  // n even: col + 1 < n too
      } else {
        store1(v0, p);
        if (col + 1 < n) store1(v1, p + 1);
      }
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, a libcuda entry point, taken from the
// libcuda.so.1 the runtime has loaded (no link against libcuda); null if
// it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, k) 16-bit matrix in boxes of WK x 128.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* p,
                  CUtensorMapDataType type, int rows, int k) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  cuuint32_t box[2] = {WK, 128};
  cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns 0, a cudaError_t, or minus the CUresult of a refused tensor map.
template <typename T>
int launch_wgmma(const void* a, const void* bt, void* c, int m, int n, int k,
                 CUtensorMapDataType type, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0
      || reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((m + WM - 1) / WM)
                        * ((n + WN - 1) / WN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_bt;
  CUresult r = make_map(encode, &map_a, a, type, m, k);
  if (r == CUDA_SUCCESS) r = make_map(encode, &map_bt, bt, type, n, k);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  // the ring passes the 48 KB a block gets unasked: raise the limit once
  // for each device
  static uint64_t smem_raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(smem_raised >> dev & 1)) {
    e = cudaFuncSetAttribute(wgmma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) smem_raised |= uint64_t{1} << dev;
  }
  wgmma_kernel<T><<<static_cast<unsigned>(tiles), WG_THREADS, WG_SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      map_a, map_bt, static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ---- float32: FP32 FMAs on the CUDA cores, fed by a cp.async ring ---------

constexpr int FMA_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int FMA_BK = 16;        // K rows a stage
constexpr int FMA_STAGES = 3;
// a ring of one stage would overwrite the stage being read
static_assert(FMA_STAGES >= 2, "the ring needs two stages or more");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Copies K rows [k0, k0 + FMA_BK) x columns [c0, c0 + W) of a row-major
// (k, ld) matrix into dst (FMA_BK x W floats, k-major) with 16-byte
// cp.async; ld is a multiple of 4, so a copy is whole or past the edge
// (then zero-filled, as are the rows past k).
template <int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int k0, int c0, int k, int ld) {
  constexpr int PER_ROW = W / 4;
  static_assert(FMA_BK * PER_ROW % FMA_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < FMA_BK * PER_ROW / FMA_THREADS; ++i) {
    const int e = i * FMA_THREADS + static_cast<int>(threadIdx.x);
    const int row = e / PER_ROW, col = (e % PER_ROW) * 4;
    const int gk = k0 + row, gc = c0 + col;
    const bool in = gk < k && gc < ld;
    cp_async16(smem_u32(dst + row * W + col),
               in ? src + static_cast<int64_t>(gk) * ld + gc : src, in);
  }
}

// C (m x n) = A B from A^T (k x lda) and B (k x ldb), row-major, lda and
// ldb = m and n rounded up to 4 (ops/matmul.py:fma_operands pads them with
// zeros). One BM x BN tile of C a block; thread (tr, tc) of the 16 x 16
// grid owns the 4 x 4 sub-tiles at rows 64 i + 4 tr, columns 64 j + 4 tc.
template <int BM, int BN>
__global__ void __launch_bounds__(FMA_THREADS, BM * BN >= 128 * 128 ? 2 : 4)
    fma_kernel(const float* __restrict__ at, const float* __restrict__ b,
               float* __restrict__ c, int m, int n, int k) {
  constexpr int SI = BM / 64, SJ = BN / 64;  // 4 x 4 sub-tiles a thread
  constexpr int A_TILE = FMA_BK * BM, STAGE = FMA_BK * (BM + BN);
  extern __shared__ __align__(16) float ring[];
  const int lda = (m + 3) & ~3, ldb = (n + 3) & ~3;

  // this block's tile: bands of GROUP_M tile rows, walked column by column
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int band = GROUP_M * tiles_n;
  const int first = (static_cast<int>(blockIdx.x) / band) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_band = static_cast<int>(blockIdx.x) % band;
  const int bm = (first + in_band % rows) * BM;
  const int bn = (in_band / rows) * BN;

  // a warp covers 4 x 8 threads: its fragment reads are 4 and 8 distinct
  // 16-byte words, one shared-memory wavefront each
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tr = (warp / 2) * 4 + lane / 8;
  const int tc = (warp % 2) * 8 + lane % 8;
  const int steps = (k + FMA_BK - 1) / FMA_BK;

  float acc[4 * SI][4 * SJ];
#pragma unroll
  for (int i = 0; i < 4 * SI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * SJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FMA_STAGES - 1; ++s) {
    if (s < steps) {
      stage_rows<BM>(ring + s * STAGE, at, s * FMA_BK, bm, k, lda);
      stage_rows<BN>(ring + s * STAGE + A_TILE, b, s * FMA_BK, bn, k, ldb);
    }
    cp_async_commit();  // empty groups keep the count of groups uniform
  }

  for (int q = 0; q < steps; ++q) {
    // step q's copies (this thread's) have landed; after the barrier,
    // everyone's have, and every thread is done with step q - 1's stage,
    // which the copies of step q + STAGES - 1 now refill
    cp_async_wait<FMA_STAGES - 2>();
    __syncthreads();
    const int next = q + FMA_STAGES - 1;
    if (next < steps) {
      float* s = ring + (next % FMA_STAGES) * STAGE;
      stage_rows<BM>(s, at, next * FMA_BK, bm, k, lda);
      stage_rows<BN>(s + A_TILE, b, next * FMA_BK, bn, k, ldb);
    }
    cp_async_commit();

    const float* as = ring + (q % FMA_STAGES) * STAGE;
    const float* bs = as + A_TILE;
    // fragments in two register buffers: row kk + 1's load while row kk's
    // FMAs run
    float4 fa[2][SI], fb[2][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
      fa[0][i] = *reinterpret_cast<const float4*>(as + 64 * i + 4 * tr);
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      fb[0][j] = *reinterpret_cast<const float4*>(bs + 64 * j + 4 * tc);
#pragma unroll
    for (int kk = 0; kk < FMA_BK; ++kk) {
      const int cur = kk % 2;
      if (kk + 1 < FMA_BK) {
#pragma unroll
        for (int i = 0; i < SI; ++i)
          fa[cur ^ 1][i] = *reinterpret_cast<const float4*>(
              as + (kk + 1) * BM + 64 * i + 4 * tr);
#pragma unroll
        for (int j = 0; j < SJ; ++j)
          fb[cur ^ 1][j] = *reinterpret_cast<const float4*>(
              bs + (kk + 1) * BN + 64 * j + 4 * tc);
      }
#pragma unroll
      for (int i = 0; i < SI; ++i) {
        const float av[4] = {fa[cur][i].x, fa[cur][i].y, fa[cur][i].z,
                             fa[cur][i].w};
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const float bv[4] = {fb[cur][j].x, fb[cur][j].y, fb[cur][j].z,
                               fb[cur][j].w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * i + r][4 * j + e] =
                  fmaf(av[r], bv[e], acc[4 * i + r][4 * j + e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block (all are empty)

  // epilogue: 16-byte stores where n is a multiple of 4, masked at m and n
  const bool vec = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = bm + 64 * i + 4 * tr + r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int col = bn + 64 * j + 4 * tc;
        if (col >= n) continue;
        float* p = c + static_cast<int64_t>(row) * n + col;
        if (vec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[4 * i + r][4 * j], acc[4 * i + r][4 * j + 1],
                          acc[4 * i + r][4 * j + 2], acc[4 * i + r][4 * j + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < n) p[e] = acc[4 * i + r][4 * j + e];
        }
      }
    }
}

template <int BM, int BN>
int launch_fma(const float* at, const float* b, float* c, int m, int n, int k,
               cudaStream_t stream) {
  constexpr int smem = FMA_STAGES * FMA_BK * (BM + BN) * 4;
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM)
                        * ((n + BN - 1) / BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // 48 KB at 128 x 128: at the limit a block gets unasked; raise it once
  // for each device all the same
  static uint64_t smem_raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(smem_raised >> dev & 1)) {
    e = cudaFuncSetAttribute(fma_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) smem_raised |= uint64_t{1} << dev;
  }
  fma_kernel<BM, BN><<<static_cast<unsigned>(tiles), FMA_THREADS, smem,
                       stream>>>(at, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 takes A^T (K, M rounded up to 4) and B (K, N rounded up to 4),
// 16-byte aligned, and the tile (128 or 64) that ops/matmul.py:fma_tile
// picks.
extern "C" int matmul_f32(const void* at, const void* b, void* c, int m,
                          int n, int k, int tile, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || reinterpret_cast<uintptr_t>(at) % 16 != 0
      || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a32 = static_cast<const float*>(at);
  const auto* b32 = static_cast<const float*>(b);
  auto* c32 = static_cast<float*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == 128) return launch_fma<128, 128>(a32, b32, c32, m, n, k, s);
  if (tile == 64) return launch_fma<64, 64>(a32, b32, c32, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 and f16 take B^T (N, K) and k a multiple of 8 (the wrapper pads K).
extern "C" int matmul_bf16(const void* a, const void* bt, void* c, int m,
                           int n, int k, void* stream) {
  return launch_wgmma<__nv_bfloat16>(a, bt, c, m, n, k,
                                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stream);
}

extern "C" int matmul_f16(const void* a, const void* bt, void* c, int m, int n,
                          int k, void* stream) {
  return launch_wgmma<__half>(a, bt, c, m, n, k,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT16, stream);
}
