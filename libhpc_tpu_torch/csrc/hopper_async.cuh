// hopper_async.cuh — mbarrier helpers shared by the kernels that wait on
// Hopper's asynchronous copies (TMA tensor copies in matmul.cu, bulk copies
// in microarch.cu).
//
// An mbarrier completes a phase when its pending arrivals reach zero and
// the bytes announced by expect_tx have all landed. A byte count that does
// not match the copies never completes the phase, and a wait on it would
// hang the card: mbar_wait polls for about ten seconds, then traps, so the
// launch fails with an error instead.

#pragma once

#include <cstdint>

namespace {

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

// makes the barriers just initialised visible to the async proxy; a
// __syncthreads() must follow before other threads use them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrive, and announce `bytes` more to land before the phase completes
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

}  // namespace
