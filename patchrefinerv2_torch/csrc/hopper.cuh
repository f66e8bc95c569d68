// Hopper building blocks shared by the wgmma kernels (csrc/quant_conv.cu,
// csrc/tail_conv.cu, csrc/gated_conv.cu): shared-memory addresses, mbarriers, bulk copies, the
// wgmma fences and the shared-memory matrix descriptor. Each source that
// includes this header is its own library; ops/_cuda.py rebuilds a source
// when a header it includes changes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// spin until the barrier's phase of this parity has completed; a barrier
// that never completes (a fault) traps after 4 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}
// this thread's shared-memory accesses are ordered before later bulk copies
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A shared-memory matrix descriptor, K-major without swizzle: core matrices
// of 8 rows by 16 bytes (rows 16 bytes apart), `lbo` bytes between the two
// core matrices of a k-step's 32 bytes (int8 k32 or bfloat16 k16: the two
// 16-byte halves of its channels), `sbo` bytes between groups of 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo = 128) {
  return (uint64_t)((addr >> 4) & 0x3fff) | (uint64_t)((lbo >> 4) & 0x3fff) << 16 | (uint64_t)((sbo >> 4) & 0x3fff) << 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int G> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(G) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

constexpr uint32_t up128(uint32_t b) { return (b + 127) / 128 * 128; }

}  // namespace hopper
