// prim_mst.cu — Prim's MST over the implicit complete mrd graph for one mpts.
//
// Ports the device loop of repro/core/boruvka.py::prim_dense_mst, the paper's
// re-run baseline (one call per mpts from repro/core/multi.py::
// hdbscan_baseline).  The reference runs it as a jax.lax.fori_loop of n-1
// steps outside any Pallas kernel; each step
//   1. computes the mrd row of the vertex added last, u:
//        row[v] = max(max(cd2[u], cd2[v]), d2(u, v)),
//   2. lowers best_w2[v] (and sets best_src[v] = u) where row[v] < best_w2[v]
//      and v is not in the tree,
//   3. adds the vertex of least best_w2 outside the tree (argmin: the lowest
//      index among equal minima).
// It returns best_src and best_w2, with w2[0] = 0 (vertex 0 starts the tree).
//
// What bounds it on the H100: the dependent chain, not the arithmetic.  The
// work is n^2 (3d + 3) operations (1.1e10 at n = 16000, d = 8: 0.16 ms at the
// float32 peak), but each step needs the previous step's argmin, so the n-1
// steps run one after another, each ending in a reduction over every vertex.
// A step can cost no less than one exchange of the candidates among the SMs
// that hold the vertices.
//
// Design.  One thread-block cluster of C blocks (16 where the card grants a
// non-portable cluster of that size, else the portable 8) on neighbouring
// SMs runs the whole loop.  Block r owns vertices [r share, (r+1) share),
// share = ceil(n / C), one or a few a thread, and keeps their state in its
// own shared memory: the points, cd2, best_w2 (with the sign bit set once
// the vertex joins the tree: best_w2 >= +0 always, so a negative entry is
// never lowered by the strict `<` and the argmin masks it as the
// reference's +inf mask does) and best_src.  A step:
//   1. each thread updates its vertices from shared memory;
//   2. the block reduces them to one candidate, a 64-bit key (value bits,
//      index) that orders exactly as the reference's argmin (tree vertices
//      count as +inf), by two redux.sync minima a warp and the same over
//      the warps;
//   3. warp 0's lanes push the key into slot r of every block of the
//      cluster (distributed shared memory, st.async), with the candidate's
//      cd2 and, up to d = 32 when the points are resident, its
//      coordinates, so that no block fetches the winner's row afterwards
//      (above that it reads x[u] from device memory); each push signals
//      the receiving block's mbarrier with its bytes (dsmem.cuh);
//   4. every block waits on its own mbarrier for the C pushes: a one-way
//      exchange, where a cluster barrier would add a round trip;
//   5. every warp reduces the C slots to the same winner u and reads u's
//      cd2 (and coordinates) from its slot; the thread that owns u marks it
//      in the tree as the next update begins.
// The slots and their mbarriers are double-buffered by step parity: a
// block pushes step s+2's slots only after it has received step s+1's
// push of every block, which each block makes after it has read its step-s
// slots.  src and w2 go to device memory once, at the end; a last cluster
// barrier keeps every block's shared memory alive until the others are
// done with it.
//
// Plans (chosen by the caller, kernels/prim_mst.py::plan_for, and checked
// here): the state (cd2, best_w2, src: 12 bytes a vertex) and the points
// (4 d bytes a vertex) are resident in shared memory while the share fits
// the budget; above it the points stream from device memory every step
// (C SMs of loads in flight instead of one), and above that the state lives
// in device memory too (cd2 read in place, best_w2 kept in w2, src in src).
//
// Bits.  d2 is summed in the reference's order for this program (kernels/
// ops.py::sum_order(d, "prim")): up to d = 32 an FMA chain in index order
// (the first square rounded alone, each later one fused into the add, fmaf),
// above it windows of 32 (zero padding split (32 W - d) / 2 in front, each
// window unfused in index order, the window sums added in order; above
// 32 x 32, windows of windows: xla_order.cuh).  The
// unfused operations are __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into an FMA, so src is equal and w2 bit-equal to the plain
// PyTorch version and to the reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dsmem.cuh"
#include "xla_order.cuh"
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;  // a block without vertices
constexpr int MAX_THREADS = 512;           // a block; past a share of 512 a thread takes several vertices
constexpr int MAX_CLUSTER = 16;            // non-portable; 8 is the portable size
constexpr int SMEM_BUDGET = 227 * 1024 - 1024;  // dynamic shared memory a block plans with
constexpr int BAR_WORDS = 4;               // the two slot buffers' mbarriers, 16 bytes
constexpr int SLOT_HEAD = 4;               // key (2 words), the candidate's cd2, a pad
constexpr int COORDS_MAX = 32;             // coordinates travel with the key up to this d

__host__ __device__ inline int slot_words(int d, bool coords) {
  return SLOT_HEAD + (coords ? (d + 3) / 4 * 4 : 0);
}

// The dynamic shared memory of a plan, in bytes: the mbarriers, the slots,
// then the share's points and state.
__host__ __device__ inline size_t plan_smem(int n, int d, int cluster, bool points, bool state) {
  const size_t share = (size_t)((n + cluster - 1) / cluster);
  size_t bytes = (BAR_WORDS + (size_t)2 * cluster * slot_words(d, points && d <= COORDS_MAX)) * sizeof(float);
  if (points) bytes += share * d * sizeof(float);
  if (state) bytes += 3 * share * sizeof(float);
  return bytes;
}

template <int D>
__host__ __device__ constexpr int vec_width() { return D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1); }

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float t = __fsub_rn(a, b);
  return __fmul_rn(t, t);
}

// d2(u, v) at a fixed width D <= 32: an FMA chain in index order.  xu in registers.
template <int D>
__device__ __forceinline__ float d2_fixed(const float* __restrict__ xv, const float (&xu)[D]) {
  constexpr int V = vec_width<D>();
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / V; ++c) {
    float t[V];
    if constexpr (V == 4) {
      const float4 q = reinterpret_cast<const float4*>(xv)[c];
      t[0] = q.x, t[1] = q.y, t[2] = q.z, t[3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = reinterpret_cast<const float2*>(xv)[c];
      t[0] = q.x, t[1] = q.y;
    } else {
      t[0] = xv[c];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float s = __fsub_rn(t[k], xu[c * V + k]);
      acc = (c == 0 && k == 0) ? __fmul_rn(s, s) : fmaf(s, s, acc);
    }
  }
  return acc;
}

// d2(u, v) at any width: an FMA chain up to 32, windows of 32 above (and
// windows of windows above 32 x 32).
__device__ __forceinline__ float d2_generic(const float* __restrict__ xv, const float* __restrict__ xu, int d) {
  if (d > 32 * 32) return tree_sum([&](int j) { return sq_diff(xv[j], xu[j]); }, d);
  if (d <= 32) {
    float acc = sq_diff(xv[0], xu[0]);
    for (int j = 1; j < d; ++j) {
      const float s = __fsub_rn(xv[j], xu[j]);
      acc = fmaf(s, s, acc);
    }
    return acc;
  }
  const int n_win = (d + 31) / 32;
  const int pad_lo = (32 * n_win - d) / 2;
  float total = 0.f;
  for (int w = 0; w < n_win; ++w) {
    const int s0 = max(0, 32 * w - pad_lo), s1 = min(d, 32 * w + 32 - pad_lo);
    float acc = sq_diff(xv[s0], xu[s0]);
    for (int j = s0 + 1; j < s1; ++j) acc = __fadd_rn(acc, sq_diff(xv[j], xu[j]));
    total = w == 0 ? acc : __fadd_rn(total, acc);
  }
  return total;
}

// The least of the warp's 64-bit keys, in every lane: the least value bits,
// then the least index among the lanes that hold them.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(k >> 32));
  const unsigned lo = __reduce_min_sync(FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

// (value bits, index): a non-negative float orders as its bits, so the key
// orders as the reference's argmin, the lower index among equal values.
__device__ __forceinline__ unsigned long long make_key(float v, int i) {
  return ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)i;
}

template <int D, bool PTS, bool STATE>
__global__ void __launch_bounds__(MAX_THREADS) prim_mst_kernel(
    const float* __restrict__ x, const float* __restrict__ cd2, int n, int d_rt, int share,
    int* __restrict__ src, float* __restrict__ w2) {
  constexpr int DR = D > 0 ? D : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int d = D > 0 ? D : d_rt;
  const bool coords = PTS && d <= COORDS_MAX;
  const int sw = slot_words(d, coords);
  // the bytes of one block's push: key, cd2 and the coordinates
  const unsigned tx = (unsigned)(C * (3 + (coords ? d : 0)) * sizeof(float));
  const int lo = min(n, r * share), cnt = min(n, lo + share) - lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;

  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_warp[MAX_THREADS / 32];
  auto* bars = reinterpret_cast<unsigned long long*>(smem);  // [2]: one a slot buffer
  float* slots = smem + BAR_WORDS;           // [2][C][sw]: keys, cd2, coordinates
  float* pts = slots + 2 * C * sw;           // [share][d] when PTS
  float* cd_s = pts + (PTS ? share * d : 0);  // [share] each when STATE
  float* best_s = cd_s + share;
  int* src_s = reinterpret_cast<int*>(best_s + share);
  const float* xs = PTS ? pts : x + (size_t)lo * d;
  const float* cdv = STATE ? cd_s : cd2 + lo;
  float* best = STATE ? best_s : w2 + lo;
  int* srcv = STATE ? src_s : src + lo;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_fence_init();
  }
  if constexpr (PTS) {
    const float* xg = x + (size_t)lo * d;
    for (int i = tid; i < cnt * d; i += blockDim.x) pts[i] = xg[i];
  }
  for (int i = tid; i < cnt; i += blockDim.x) {
    if constexpr (STATE) cd_s[i] = cd2[lo + i];
    best[i] = lo + i == 0 ? -0.f : CUDART_INF_F;  // vertex 0 starts the tree
    srcv[i] = 0;
  }
  cluster.sync();  // every block of the cluster runs, holds its share and its mbarriers

  int u = 0;
  float cu = cd2[0];
  const float* xu_p = x;  // the winner's row: its slot's coordinates or x[u]
  for (int step = 0; step + 1 < n; ++step) {
    const int par = step & 1;
    if (tid == 0) mbar_expect_tx(&bars[par], tx);
    float xu[DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) xu[j] = xu_p[j];
    }
    unsigned long long key = NO_KEY;
    for (int i = tid; i < cnt; i += blockDim.x) {
      float b = best[i];
      if (lo + i == u) best[i] = b = copysignf(b, -1.f);  // the last winner joins the tree
      const bool in_tree = signbit(b);
      if (!in_tree) {
        const float* xv = xs + (size_t)i * d;
        float dd;
        if constexpr (D > 0) dd = d2_fixed<D>(xv, xu);
        else dd = d2_generic(xv, xu_p, d);
        const float row = fmaxf(fmaxf(cu, cdv[i]), dd);
        if (row < b) {
          b = row;
          best[i] = row;
          srcv[i] = u;
        }
      }
      // the reference masks tree vertices with +inf before its argmin
      const unsigned long long k = make_key(in_tree ? CUDART_INF_F : b, lo + i);
      key = k < key ? k : key;
    }
    key = warp_min(key);
    if (lane == 0) s_warp[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = warp_min(lane < nw ? s_warp[lane] : NO_KEY);
      if (lane < C) {  // the block's candidate into slot r of block `lane`
        const int i = key == NO_KEY ? -1 : (int)(unsigned)key - lo;
        float* dst = slots + (par * C + r) * sw;
        push_u64(dst, key, &bars[par], lane);
        push_f32(dst + 2, i < 0 ? 0.f : cdv[i], &bars[par], lane);
        if (coords) {
          const float* xv = xs + (size_t)(i < 0 ? 0 : i) * d;
          if constexpr (D > 0 && D % 4 == 0) {
#pragma unroll
            for (int c = 0; c < D / 4; ++c)
              push_f32x4(dst + SLOT_HEAD + 4 * c, reinterpret_cast<const float4*>(xv)[c], &bars[par], lane);
          } else {
            for (int j = 0; j < d; ++j) push_f32(dst + SLOT_HEAD + j, xv[j], &bars[par], lane);
          }
        }
      }
    }
    mbar_wait(&bars[par], (step >> 1) & 1);
    // every warp reduces the C slots to the same winner, and finds its slot
    const unsigned long long mine =
        lane < C ? *reinterpret_cast<const unsigned long long*>(slots + (par * C + lane) * sw) : NO_KEY;
    key = warp_min(mine);
    u = (int)(unsigned)key;
    const int owner = __ffs(__ballot_sync(FULL, mine == key)) - 1;
    const float* slot = slots + (par * C + owner) * sw;
    cu = slot[2];
    xu_p = coords ? slot + SLOT_HEAD : x + (size_t)u * d;
  }
  for (int i = tid; i < cnt; i += blockDim.x) {
    w2[lo + i] = fabsf(best[i]);
    if constexpr (STATE) src[lo + i] = srcv[i];
  }
  cluster.sync();  // no block leaves while another may still push into it
}

// The step floor: the key exchange of prim_mst_kernel alone (each block's
// warp 0 pushes an 8-byte key to every block, every block waits on its
// mbarrier and reduces the C keys), `steps` times, at the same cluster
// shape, with its block barrier a step; no update, no warp reduction of
// candidates, no cd2 or coordinates.  The barrier keeps every warp within
// one step of warp 0: a warp two phases behind would wait on the parity of
// a later phase and read slots that warp 0's next pushes overwrite.
__global__ void __launch_bounds__(MAX_THREADS) prim_mst_floor_kernel(int steps, unsigned* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  extern __shared__ __align__(16) float smem[];
  auto* bars = reinterpret_cast<unsigned long long*>(smem);
  auto* slots = reinterpret_cast<unsigned long long*>(smem + BAR_WORDS);  // [2][C]
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_fence_init();
  }
  cluster.sync();
  unsigned long long key = 0;
  for (int step = 0; step < steps; ++step) {
    const int par = step & 1;
    __syncthreads();  // every warp has read the last step's slots
    if (tid == 0) mbar_expect_tx(&bars[par], (unsigned)(C * sizeof(unsigned long long)));
    if (tid < 32 && lane < C)
      push_u64(&slots[par * C + r], ((unsigned long long)(step * 2654435761u + (unsigned)r) << 32) | (unsigned)key,
               &bars[par], lane);
    mbar_wait(&bars[par], (step >> 1) & 1);
    key = warp_min(lane < C ? slots[par * C + lane] : NO_KEY);
  }
  if (tid == 0) out[r] = (unsigned)key;
  cluster.sync();
}

using Kernel = void (*)(const float*, const float*, int, int, int, int*, float*);

template <int D>
Kernel pick_d(bool points, bool state) {
  if (!state) return prim_mst_kernel<D, false, false>;
  return points ? prim_mst_kernel<D, true, true> : prim_mst_kernel<D, false, true>;
}

Kernel pick(int d, bool points, bool state) {
  switch (d) {
    case 2: return pick_d<2>(points, state);
    case 4: return pick_d<4>(points, state);
    case 8: return pick_d<8>(points, state);
    case 16: return pick_d<16>(points, state);
    case 32: return pick_d<32>(points, state);
    default: return pick_d<0>(points, state);
  }
}

template <typename K>
cudaError_t prepare(K kernel, int cluster, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_shape(int cluster, int threads) {
  return cluster >= 1 && cluster <= MAX_CLUSTER && threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

}  // namespace

// x: (n, d) f32 row-major, 16-byte aligned; cd2: (n,) f32 squared core
// distances of one mpts; src: (n,) i32 and w2: (n,) f32 outputs (w2[0] = 0,
// src[0] = 0).  The plan: a cluster of `cluster` blocks of `threads`
// threads, the points (`points`) and the state (`state`) resident in shared
// memory or not; the points only with the state.  Returns the cudaError_t
// of the launch (0 on success), cudaErrorInvalidValue for a plan that does
// not fit the shared-memory budget.
extern "C" int repro_prim_mst(const float* x, const float* cd2, int n, int d, int cluster, int threads,
                              int points, int state, int* src, float* w2, void* stream) {
  if (n < 1 || d < 1 || reinterpret_cast<size_t>(x) % 16 != 0 || !valid_shape(cluster, threads) ||
      (points && !state))
    return (int)cudaErrorInvalidValue;
  const size_t smem = plan_smem(n, d, cluster, points, state);
  if (smem > (size_t)SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  const Kernel k = pick(d, points, state);
  cudaError_t e = prepare(k, cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, (cudaStream_t)stream, &attr);
  const int share = (n + cluster - 1) / cluster;
  e = cudaLaunchKernelEx(&cfg, k, x, cd2, n, d, share, src, w2);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The shared-memory bytes a block may plan with (kernels/prim_mst.py mirrors it).
extern "C" int repro_prim_mst_smem_budget() { return SMEM_BUDGET; }

// cudaOccupancyMaxActiveClusters for the kernel instance of (d, points,
// state) at a cluster shape and dynamic shared memory: how many such
// clusters the card holds at once (0: it refuses the shape), or minus the
// cudaError_t of the query.
extern "C" int repro_prim_mst_max_active_clusters(int d, int cluster, int threads, int smem, int points,
                                                  int state) {
  if (d < 1 || !valid_shape(cluster, threads) || (points && !state) || smem < 0 || smem > SMEM_BUDGET)
    return -(int)cudaErrorInvalidValue;
  const Kernel k = pick(d, points, state);
  cudaError_t e = prepare(k, cluster, (size_t)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, (size_t)smem, nullptr, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, k, &cfg);
  return e != cudaSuccess ? -(int)e : count;
}

// The step floor: `steps` steps of the key exchange alone, at a cluster of `cluster` blocks of `threads` threads; out: (cluster,)
// u32 scratch.  Returns the cudaError_t of the launch.
extern "C" int repro_prim_mst_floor(int steps, int cluster, int threads, unsigned* out, void* stream) {
  if (steps < 0 || !valid_shape(cluster, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = (BAR_WORDS + 2 * cluster * 2) * sizeof(float);
  cudaError_t e = prepare(prim_mst_floor_kernel, cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, prim_mst_floor_kernel, steps, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
