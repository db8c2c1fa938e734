// dsmem.cuh for the CPU emulation (cuda_stub_core.h): an mbarrier is a
// mutex and a condition variable whose address the 8-byte shared-memory
// word holds; a push stores into the target block's shared memory and
// counts its bytes off the target's mbarrier, as st.async ...
// mbarrier::complete_tx does.  A phase completes when its one arrival
// (mbar_expect_tx) has come and the byte count is back at 0.
#pragma once
#include <condition_variable>

struct StubMbar {
  std::mutex mu;
  std::condition_variable cv;
  int pending = 1;
  long long tx = 0;
  int phase = 0;
};
inline StubMbar*& stub_mbar(unsigned long long* bar) { return *reinterpret_cast<StubMbar**>(bar); }
inline void stub_mbar_settle(StubMbar* m) {
  if (m->pending == 0 && m->tx == 0) {
    m->phase ^= 1;
    m->pending = 1;
    m->cv.notify_all();
  }
}
inline void mbar_init(unsigned long long* bar) {
  auto m = std::make_shared<StubMbar>();
  StubBlock& b = stub_block();
  std::lock_guard<std::mutex> g(b.mu);
  b.owned.push_back(m);
  stub_mbar(bar) = m.get();
}
inline void mbar_fence_init() {}
inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  StubMbar* m = stub_mbar(bar);
  std::lock_guard<std::mutex> g(m->mu);
  m->tx += bytes;
  m->pending -= 1;
  stub_mbar_settle(m);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  StubMbar* m = stub_mbar(bar);
  std::unique_lock<std::mutex> g(m->mu);
  stub_wait(m->cv, g, [&] { return (unsigned)m->phase != parity; }, "mbar_wait");
}
template <typename T>
inline void stub_push(T* dst, T v, unsigned long long* bar, unsigned rank) {
  auto cluster = cooperative_groups::this_cluster();
  *cluster.map_shared_rank(dst, rank) = v;
  StubMbar* m = stub_mbar(cluster.map_shared_rank(bar, rank));
  std::lock_guard<std::mutex> g(m->mu);
  m->tx -= (long long)sizeof(T);
  stub_mbar_settle(m);
}
inline void push_u64(void* dst, unsigned long long v, unsigned long long* bar, unsigned rank) {
  stub_push((unsigned long long*)dst, v, bar, rank);
}
inline void push_f32(float* dst, float v, unsigned long long* bar, unsigned rank) { stub_push(dst, v, bar, rank); }
inline void push_f32x4(float* dst, float4 v, unsigned long long* bar, unsigned rank) {
  stub_push((float4*)dst, v, bar, rank);
}
