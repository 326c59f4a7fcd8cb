// mbarriers and 1-D bulk copies (cp.async.bulk, sm_90), shared by the
// kernels that stream through a ring of shared-memory slots: K12's weight
// panels (gather_wf_mm.cu) and K5's embedding slabs (rpe_attention_ws.cuh);
// and 16-byte cp.async under an L2 policy (K10's and K11's streams).
// A slot's "full" barrier completes when its bytes have landed (one arrival
// with expect_tx, then the copy's complete_tx); its "empty" barrier when
// every consumer has arrived.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

namespace se3et {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// mbar_wait that traps after about 2^33 cycles (seconds) instead of
// hanging the card on an arrival that never comes; `what` names the wait in
// the message
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity, int what) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) {
      printf("mbarrier wait %d timed out: block %d thread %d parity %u\n", what, blockIdx.x,
             threadIdx.x, parity);
      __trap();
    }
  }
}
// a bulk global -> shared copy that signals `bar` with its bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// an L2 policy under which the lines a copy brings in are evicted first:
// for a stream that is read once
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
// bulk_load under an L2 policy
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");
}

// cp.async of 16 bytes under an L2 policy, zero-filled where !ok
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool ok,
                                                uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(ok ? 16 : 0), "l"(policy));
}

}  // namespace se3et
