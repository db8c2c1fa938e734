// dsmem.cuh — one-way pushes between the blocks of a thread-block cluster
// (Hopper's distributed shared memory), used by prim_mst.cu.
//
// A push stores into the shared memory of the block of rank `rank` at the
// address that `dst` has in the caller's own block (the cluster's blocks
// share one layout), and signals that block's mbarrier, at the address `bar`
// has in the caller's block, with the bytes it wrote (st.async ...
// mbarrier::complete_tx::bytes).  The receiver arms its mbarrier once a
// phase with the bytes it expects (mbar_expect_tx: one arrival) and waits
// for the phase with acquire semantics at cluster scope, after which every
// pushed value is visible to all its threads.  A push may land before the
// receiver arms the phase: the transaction count goes negative meanwhile.

#pragma once

__device__ __forceinline__ unsigned cta_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// a pure address computation: not volatile, so the compiler may hoist it
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(cta_addr(p)), "r"(rank));
  return r;
}

// one arrival a phase: the receiver's mbar_expect_tx
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(cta_addr(bar)) : "memory");
}

// makes the initialised mbarriers visible to the cluster (a cluster barrier follows)
__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(cta_addr(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = cta_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void push_u64(void* dst, unsigned long long v, unsigned long long* bar, unsigned rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "l"(v), "r"(cluster_addr(bar, rank))
               : "memory");
}

__device__ __forceinline__ void push_f32(float* dst, float v, unsigned long long* bar, unsigned rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "r"(__float_as_uint(v)), "r"(cluster_addr(bar, rank))
               : "memory");
}

// 16 bytes; dst 16-byte aligned
__device__ __forceinline__ void push_f32x4(float* dst, float4 v, unsigned long long* bar, unsigned rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
               "r"(__float_as_uint(v.w)), "r"(cluster_addr(bar, rank))
               : "memory");
}
