// cuda_stub_core.h — a CPU emulation of the CUDA features that the port's
// chain kernels (prim_mst.cu, single_linkage.cu), sbcn_tile.cu, the norms
// pre-pass (norms_win32.cuh) and pairwise_topk.cu use, for g++: every CUDA
// thread of a launch is a std::thread, so barriers, warp reductions and
// pushes between the blocks of a cluster run as they would on the card,
// one ordering of them at a time.  Shared memory is a byte buffer a block
// (static arrays by name, through STUB_SHARED); a cluster's blocks map each
// other's dynamic shared memory by offset.  See tools/cuda_emulate/__init__.py.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <condition_variable>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
using std::max;
using std::min;
using std::signbit;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

#define CUDART_INF_F INFINITY
// volatile keeps g++ from contracting them into an FMA (with -ffp-contract=off as well)
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }

struct StubBlock {
  std::vector<char> dyn;                              // dynamic shared memory
  std::map<std::string, std::vector<char>> stat;      // static shared arrays by name
  std::mutex mu;
  std::unique_ptr<std::barrier<>> bar;                // __syncthreads
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::vector<unsigned>> warp_vals;       // redux.sync and ballot operands
  std::vector<std::vector<uint64_t>> warp_vals64;     // shuffle and match operands
  std::vector<std::shared_ptr<void>> owned;           // objects that live as long as the launch
};
struct StubGrid {
  std::vector<std::unique_ptr<StubBlock>> blocks;
  std::vector<std::unique_ptr<std::barrier<>>> cluster_bar;
  int cluster = 1;
};
inline thread_local StubGrid* stub_grid = nullptr;
inline thread_local unsigned stub_block_id = 0;  // the block's linear index in its grid
inline StubBlock& stub_block() { return *stub_grid->blocks[stub_block_id]; }

inline void __syncthreads() { stub_block().bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { stub_block().warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
// every lane of the warp takes part, as in the kernels
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  StubBlock& b = stub_block();
  const int w = threadIdx.x / 32;
  b.warp_vals[w][threadIdx.x % 32] = v;
  b.warp_bar[w]->arrive_and_wait();
  unsigned m = 0xffffffffu;
  for (unsigned x : b.warp_vals[w]) m = std::min(m, x);
  b.warp_bar[w]->arrive_and_wait();
  return m;
}

inline unsigned __ballot_sync(unsigned, bool pred) {
  StubBlock& b = stub_block();
  const int w = threadIdx.x / 32;
  b.warp_vals[w][threadIdx.x % 32] = pred;
  b.warp_bar[w]->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (b.warp_vals[w][l] ? 1u : 0u) << l;
  b.warp_bar[w]->arrive_and_wait();
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clzll(long long x) { return x == 0 ? 64 : __builtin_clzll((unsigned long long)x); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline bool __any_sync(unsigned m, bool pred) { return __ballot_sync(m, pred) != 0u; }
inline bool __all_sync(unsigned m, bool pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }

// every lane's value of v (at most 8 bytes), the warp's lanes all taking part
template <typename T>
std::vector<T> stub_warp_values(T v) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  StubBlock& b = stub_block();
  const int w = threadIdx.x / 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  b.warp_vals64[w][threadIdx.x % 32] = bits;
  b.warp_bar[w]->arrive_and_wait();
  std::vector<T> all(32);
  for (int l = 0; l < 32; ++l) std::memcpy(&all[l], &b.warp_vals64[w][l], sizeof(T));
  b.warp_bar[w]->arrive_and_wait();
  return all;
}
template <typename T>
T __shfl_sync(unsigned, T v, int src) { return stub_warp_values(v)[src & 31]; }
template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  const T got = stub_warp_values(v)[lane >= delta ? lane - delta : lane];
  return lane >= delta ? got : v;
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int m) { return stub_warp_values(v)[(threadIdx.x % 32) ^ (unsigned)m]; }
template <typename T>
unsigned __match_any_sync(unsigned, T v) {
  const std::vector<T> all = stub_warp_values(v);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (all[l] == v ? 1u : 0u) << l;
  return m;
}

// An emulated wait (an mbarrier's phase) that has not ended after
// STUB_WAIT_LIMIT fails the launch instead of hanging it: the wait and every
// later one return at once, and the launch and cudaGetLastError report
// cudaErrorLaunchTimeout, so that a kernel waiting on a phase that never
// comes fails its test.
inline std::atomic<bool> stub_wait_timed_out{false};
inline constexpr std::chrono::seconds STUB_WAIT_LIMIT{120};
template <typename Lock, typename Pred>
void stub_wait(std::condition_variable& cv, Lock& lock, Pred done, const char* what) {
  const auto give_up = std::chrono::steady_clock::now() + STUB_WAIT_LIMIT;
  while (!done()) {
    if (stub_wait_timed_out) return;
    if (std::chrono::steady_clock::now() > give_up) {
      std::fprintf(stderr, "cuda_emulate: %s waited %llds for a phase that never came\n", what,
                   (long long)STUB_WAIT_LIMIT.count());
      stub_wait_timed_out = true;
      return;
    }
    cv.wait_for(lock, std::chrono::milliseconds(200));
  }
}
// cudaErrorLaunchTimeout once after a timed-out wait, else cudaSuccess
inline int stub_take_timeout() { return stub_wait_timed_out.exchange(false) ? 6 : 0; }

inline void* stub_dyn_smem() { return stub_block().dyn.data(); }
inline void* stub_static_smem(const char* name, size_t bytes) {
  StubBlock& b = stub_block();
  std::lock_guard<std::mutex> g(b.mu);
  auto& v = b.stat[name];
  if (v.empty()) v.assign(bytes, 0);
  return v.data();
}
#define STUB_SHARED(T, name, N) T* name = (T*)stub_static_smem(#name, sizeof(T) * (N))

namespace cooperative_groups {
struct cluster_group {
  unsigned num_blocks() const { return stub_grid->cluster; }
  unsigned block_rank() const { return blockIdx.x % stub_grid->cluster; }
  void sync() const { stub_grid->cluster_bar[blockIdx.x / stub_grid->cluster]->arrive_and_wait(); }
  // p must lie in the caller's dynamic shared memory
  template <typename T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const size_t off = (char*)p - stub_block().dyn.data();
    const unsigned target = blockIdx.x / stub_grid->cluster * stub_grid->cluster + rank;
    return (T*)(stub_grid->blocks[target]->dyn.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// Run `kernel` on `grid` blocks of `block` threads (block a multiple of 32),
// `smem` bytes of dynamic shared memory each, in clusters of `cluster` (a
// cluster's blocks along x).
template <typename K, typename... A>
void stub_run(K kernel, dim3 grid_dim, unsigned block, size_t smem, int cluster, A... args) {
  const unsigned grid = grid_dim.x * grid_dim.y * grid_dim.z;
  StubGrid g;
  g.cluster = cluster;
  for (unsigned b = 0; b < grid; ++b) {
    auto blk = std::make_unique<StubBlock>();
    blk->dyn.assign(smem + 16, 0);
    blk->bar = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < block / 32; ++w) {
      blk->warp_bar.push_back(std::make_unique<std::barrier<>>(32));
      blk->warp_vals.emplace_back(32, 0u);
      blk->warp_vals64.emplace_back(32, 0ull);
    }
    g.blocks.push_back(std::move(blk));
  }
  for (unsigned c = 0; c < grid / cluster; ++c)
    g.cluster_bar.push_back(std::make_unique<std::barrier<>>(cluster * block));
  // every block at once, or with STUB_BLOCK_BATCH defined and no clusters
  // that many at a time (for kernels whose blocks never wait on each other)
#ifdef STUB_BLOCK_BATCH
  const unsigned batch = cluster == 1 ? STUB_BLOCK_BATCH : grid;
#else
  const unsigned batch = grid;
#endif
  for (unsigned b0 = 0; b0 < grid; b0 += batch) {
    std::vector<std::thread> ts;
    for (unsigned b = b0; b < grid && b < b0 + batch; ++b)
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([&, b, t] {
          stub_grid = &g;
          stub_block_id = b;
          blockIdx = dim3(b % grid_dim.x, b / grid_dim.x % grid_dim.y, b / (grid_dim.x * grid_dim.y));
          threadIdx = dim3(t);
          blockDim = dim3(block);
          gridDim = grid_dim;
          kernel(args...);
        });
    for (auto& t : ts) t.join();
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) without clusters
template <typename K, typename S, typename... A>
void stub_launch(K kernel, dim3 grid, unsigned block, size_t smem, S, A... args) {
  stub_run(kernel, grid, block, smem, 1, args...);
}
