// dia.cu — streaming DIA SpMV (K4) and its pattern probe (K5) for Hopper
// (sm_90a).
//
// Replaces the TPU kernels libhpc_tpu/ops/dia_pallas.py:_kernel (K4) and
// libhpc_tpu/ops/dia_pallas.py:_probe_kernel (K5). In the layout of
// ops/spmv_dia.py (rows of all tiles consecutive, r = g T + i):
//
//   K4  out[r] = sum_d plane[g, d, i] * x_ext[r + coffs[d]]
//   K5  out[r] = x_ext[r] + x_ext[r + span_pad] + sum_d plane[g, d, i]
//
// with plane[g, d, i] = dflat[(g D + d) T + i]. Sums are f32, in diagonal
// order, as in the reference.
//
// Design:
//   - The TPU kernel DMAs each tile's x window into VMEM and forms every
//     shifted read with two lane rolls and a select. On Hopper a shifted
//     read is a plain load of x_ext[r + c_d]; the D loads of one row hit
//     the same few cache lines, so x comes from L1/L2 after its first read.
//   - The grid is not tied to T: at T = 2^17 Poisson 3072^2 has only 72
//     tiles for 132 SMs. Each thread takes 4 consecutive rows (T is a
//     multiple of 128, so 4 rows never straddle a tile), and tile g and row
//     i come from the global row. Neighbouring threads take neighbouring
//     rows, so plane loads (16 bytes a thread) and output stores coalesce.
//   - coffs (at most 96 ints) travels by value in the kernel's parameters.
//   - Index arithmetic is 64-bit: n_tiles D T passes 2^31 at D = 96.
//
// What bounds it: bytes. The planes (D T 4 bytes per tile) are read once and
// dominate; x is read once from HBM plus the span_pad overlap per tile, y
// written once — the hbm_bytes model of DiaPallas. At 3.35 TB/s, Poisson
// 3072^2 (266 MB) has a floor of about 80 us.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 96;  // ops/spmv.py MAX_DIA_OFFSETS
constexpr int kThreads = 256;

struct Coffs {
  int c[kMaxD];
};

template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
    dia_kernel(const float4* __restrict__ dflat,
               const float* __restrict__ x_ext, float4* __restrict__ out,
               Coffs co, int D, int64_t T, int64_t span_pad,
               int64_t n_quads) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const int64_t r = 4 * q;  // first of this thread's four rows
  const int64_t g = r / T;
  const int64_t i = r - g * T;
  const float4* plane = dflat + (g * D * T + i) / 4;
  const int64_t plane_stride = T / 4;

  float4 acc;
  if (kProbe) {
    const float* a = x_ext + r;
    const float* b = x_ext + r + span_pad;
    acc = make_float4(__ldg(a) + __ldg(b), __ldg(a + 1) + __ldg(b + 1),
                      __ldg(a + 2) + __ldg(b + 2), __ldg(a + 3) + __ldg(b + 3));
  } else {
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 v = __ldg(plane + d * plane_stride);
    if (kProbe) {
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    } else {
      const float* xs = x_ext + r + co.c[d];
      acc.x += v.x * __ldg(xs);
      acc.y += v.y * __ldg(xs + 1);
      acc.z += v.z * __ldg(xs + 2);
      acc.w += v.w * __ldg(xs + 3);
    }
  }
  out[q] = acc;
}

template <bool kProbe>
int launch_dia(const void* dflat, const void* x_ext, const void* coffs,
               void* out, int n_tiles, int D, int T, int span_pad,
               void* stream) {
  if (D < 1 || D > kMaxD || T <= 0 || T % 128 != 0 || n_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Coffs co = {};
  const int* c = static_cast<const int*>(coffs);
  for (int d = 0; d < D; ++d) co.c[d] = c[d];
  const int64_t n_quads = static_cast<int64_t>(n_tiles) * T / 4;
  if (n_quads > 0) {
    const int64_t blocks = (n_quads + kThreads - 1) / kThreads;
    dia_kernel<kProbe><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(dflat), static_cast<const float*>(x_ext),
        static_cast<float4*>(out), co, D, T, span_pad, n_quads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coffs is a HOST array of D ints, copied into the launch parameters.
extern "C" int dia_spmv_f32(const void* dflat, const void* x_ext,
                            const void* coffs, void* out, int n_tiles, int D,
                            int T, int span_pad, void* stream) {
  return launch_dia<false>(dflat, x_ext, coffs, out, n_tiles, D, T, span_pad,
                           stream);
}

extern "C" int dia_probe_f32(const void* dflat, const void* x_ext,
                             const void* coffs, void* out, int n_tiles, int D,
                             int T, int span_pad, void* stream) {
  return launch_dia<true>(dflat, x_ext, coffs, out, n_tiles, D, T, span_pad,
                          stream);
}
