// Hopper (sm_90a) building blocks shared by the flash kernels of both element
// types (tf32_mma.cuh for float32, bf16_mma.cuh for bfloat16): wgmma's
// shared-memory descriptor and its fences, the exp unit, cp.async groups.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the exp unit (MUFU.EX2); 2^-inf = 0, results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma operand in shared memory without swizzle: core matrices of 8 rows x
// 16 bytes, each stored as 128 contiguous bytes; lbo and sbo in bytes (their
// roles depend on the operand's major-ness: tf32_mma.cuh, bf16_mma.cuh).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);  // no swizzle, base offset 0
}

// Orders this thread's generic-proxy shared-memory writes before the async
// proxy's (wgmma's) reads; a barrier then publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// Keeps a register in place across asynchronous wgmma reads and writes.
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The backward's ordered dq accumulation (flash_bwd.cu, flash_bwd_bf16.cu):
// the block of key block kb adds its dq of a query tile only once the tile's
// counter reads kb, i.e. after block kb - 1 has added its own, so the float32
// sums run in key-block order and two calls give the same bits. A block waits
// only on blocks of lower linear index, which the hardware has already
// started, so the waits cannot deadlock. A wait that outlasts 2^24 polls
// (seconds; a real one lasts micro- to milliseconds) traps, so that a fault
// shows as a launch error and not as a hung card.
__device__ __forceinline__ void wait_count(const int* count, int want) {
  int v;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    if (v == want) return;
    if (polls == (1u << 24)) __trap();
    __nanosleep(32);
  }
}
__device__ __forceinline__ void release_count(int* count, int value) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(count), "r"(value) : "memory");
}

}  // namespace tdt
