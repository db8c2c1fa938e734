// stage_ring.cuh — a ring of shared-memory stages filled with cp.async and
// tracked by mbarriers (sbcn_tile.cu).  Every thread both fills and reads
// the ring: its copies into a stage arrive on the stage's `full` barrier
// once they have landed (cp.async.mbarrier.arrive.noinc: one arrival a
// thread a phase), and it arrives on the stage's `empty` barrier once it
// has read the stage, so a thread waits only for the stage it needs next
// and for the readers of the stage it refills, never on a block-wide
// barrier a stage.

#pragma once

#include "cp_async.cuh"

__device__ __forceinline__ unsigned ring_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// `count` arrivals a phase; a __syncthreads must follow before any wait
__device__ __forceinline__ void ring_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(ring_addr(bar)), "r"(count) : "memory");
}

// one arrival on `bar` once the calling thread's earlier cp.async copies have landed
__device__ __forceinline__ void ring_copies_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(ring_addr(bar)) : "memory");
}

__device__ __forceinline__ void ring_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(ring_addr(bar)) : "memory");
}

// wait for the completion of the phase of parity `parity` (the phase before
// the first counts as complete: waiting on parity 1 at first returns at once)
__device__ __forceinline__ void ring_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = ring_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
