// cp_async.cuh — Ampere/Hopper asynchronous copies from global to shared
// memory, shared by the sliced instances of pairwise_topk.cu and
// lune_filter.cu and by sbcn_tile.cu's stage ring (stage_ring.cuh).

#pragma once

// 16 or 4 bytes from global to shared memory, bypassing registers; with
// `pred` false the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
// 16 bytes of shared memory from the first `bytes` (0 to 16) at src, the
// rest zero-filled
__device__ __forceinline__ void cp_async16_bytes(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
