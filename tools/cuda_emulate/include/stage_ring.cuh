// stage_ring.cuh for the CPU emulation (cuda_stub_core.h): an mbarrier of
// `count` arrivals a phase is a mutex and a condition variable whose
// address the 8-byte shared-memory word holds; the copies of cp_async.cuh
// land at once, so their arrival is an arrival.
#pragma once
#include <condition_variable>

#include "cp_async.cuh"
#include "dsmem.cuh"

struct StubRing {
  std::mutex mu;
  std::condition_variable cv;
  unsigned count = 0, pending = 0;
  unsigned phase = 0;  // the parity of the phase under way
};
inline StubRing*& stub_ring(unsigned long long* bar) { return *reinterpret_cast<StubRing**>(bar); }
inline void ring_init(unsigned long long* bar, unsigned count) {
  auto m = std::make_shared<StubRing>();
  m->count = m->pending = count;
  StubBlock& b = stub_block();
  std::lock_guard<std::mutex> g(b.mu);
  b.owned.push_back(m);
  stub_ring(bar) = m.get();
}
inline void ring_arrive(unsigned long long* bar) {
  StubRing* m = stub_ring(bar);
  std::lock_guard<std::mutex> g(m->mu);
  if (--m->pending == 0) {
    m->pending = m->count;
    m->phase ^= 1;
    m->cv.notify_all();
  }
}
inline void ring_copies_arrive(unsigned long long* bar) { ring_arrive(bar); }
// as mbarrier.try_wait.parity: ends once the phase of this parity has completed
inline void ring_wait(unsigned long long* bar, unsigned parity) {
  StubRing* m = stub_ring(bar);
  std::unique_lock<std::mutex> g(m->mu);
  stub_wait(m->cv, g, [&] { return m->phase != parity; }, "ring_wait");
}
