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
// steps run one after another, each ending in a block-wide reduction.
//
// Design.  One thread block of 1024 threads runs the whole loop: a step is a
// strided pass over the vertices (thread t owns v = t, t + 1024, ...), a warp
// shuffle argmin over (value, index) pairs, one across the warps, and two
// __syncthreads.  The state is one float a vertex: best_w2, with the sign bit
// set once the vertex joins the tree (best_w2 >= +0 always, so a negative
// entry is never lowered by the strict `<` and is skipped by the argmin as
// the reference's +inf mask is).  best_src is written only, in device memory.
// best_w2 sits in shared memory up to SMEM_MAX / 4 vertices (51200), and in
// the output w2 itself above that (L2-resident: 4 n bytes).  The points are
// read from device memory each step (L2 at n = 16000, d = 8: 512 KB).
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

#include <cuda_runtime.h>

#include "xla_order.cuh"
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, dynamic smem needs an opt-in
constexpr int SMEM_MAX = 200 * 1024;     // best_w2 in shared memory up to 51200 vertices

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

// (value, index) argmin step: the smaller value, the lower index among equals.
__device__ __forceinline__ void arg_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) v = ov, i = oi;
}

template <int D, bool SMEM>
__global__ void __launch_bounds__(THREADS) prim_mst_kernel(
    const float* __restrict__ x, const float* __restrict__ cd2, int n, int d_rt,
    int* __restrict__ src, float* __restrict__ w2) {
  constexpr int DR = D > 0 ? D : 1;
  const int d = D > 0 ? D : d_rt;
  extern __shared__ float smem[];
  __shared__ float s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  __shared__ int s_last;
  float* best = SMEM ? smem : w2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = (blockDim.x + 31) >> 5;

  for (int v = tid; v < n; v += blockDim.x) {
    best[v] = v == 0 ? -0.f : CUDART_INF_F;  // vertex 0 starts the tree
    src[v] = 0;
  }
  if (tid == 0) s_last = 0;
  __syncthreads();

  for (int step = 0; step + 1 < n; ++step) {
    const int u = s_last;
    const float cu = cd2[u];
    const float* xu_g = x + (size_t)u * d;
    float xu[DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) xu[j] = xu_g[j];
    }
    float mv = CUDART_INF_F;
    int mi = 0x7fffffff;
    for (int v = tid; v < n; v += blockDim.x) {
      float b = best[v];
      const bool in_tree = signbit(b);
      if (!in_tree) {
        const float* xv = x + (size_t)v * d;
        float dd;
        if constexpr (D > 0) dd = d2_fixed<D>(xv, xu);
        else dd = d2_generic(xv, xu_g, d);
        const float row = fmaxf(fmaxf(cu, cd2[v]), dd);
        if (row < b) {
          b = row;
          best[v] = row;
          src[v] = u;
        }
      }
      // the reference masks tree vertices with +inf before its argmin
      arg_min(mv, mi, in_tree ? CUDART_INF_F : b, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      arg_min(mv, mi, __shfl_xor_sync(FULL, mv, off), __shfl_xor_sync(FULL, mi, off));
    if (lane == 0) s_val[warp] = mv, s_idx[warp] = mi;
    __syncthreads();
    if (warp == 0) {
      mv = lane < nw ? s_val[lane] : CUDART_INF_F;
      mi = lane < nw ? s_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        arg_min(mv, mi, __shfl_xor_sync(FULL, mv, off), __shfl_xor_sync(FULL, mi, off));
      if (lane == 0) {
        best[mi] = copysignf(best[mi], -1.f);  // joins the tree
        s_last = mi;
      }
    }
    __syncthreads();
  }
  for (int v = tid; v < n; v += blockDim.x) w2[v] = fabsf(best[v]);
}

template <int D>
int launch(const float* x, const float* cd2, int n, int d, bool global, int* src, float* w2,
           cudaStream_t stream) {
  const size_t smem = global ? 0 : (size_t)n * sizeof(float);
  if (global) {
    prim_mst_kernel<D, false><<<1, THREADS, 0, stream>>>(x, cd2, n, d, src, w2);
    return (int)cudaGetLastError();
  }
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        prim_mst_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  prim_mst_kernel<D, true><<<1, THREADS, smem, stream>>>(x, cd2, n, d, src, w2);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) f32 row-major, 16-byte aligned; cd2: (n,) f32 squared core
// distances of one mpts; src: (n,) i32 and w2: (n,) f32 outputs (w2[0] = 0,
// src[0] = 0).  best_w2 lives in shared memory when n <= 51200 and in w2
// above.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_prim_mst(const float* x, const float* cd2, int n, int d, int* src, float* w2,
                              void* stream) {
  if (n < 1 || d < 1 || reinterpret_cast<size_t>(x) % 16 != 0) return (int)cudaErrorInvalidValue;
  const bool global = (size_t)n * sizeof(float) > (size_t)SMEM_MAX;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 2: return launch<2>(x, cd2, n, d, global, src, w2, s);
    case 4: return launch<4>(x, cd2, n, d, global, src, w2, s);
    case 8: return launch<8>(x, cd2, n, d, global, src, w2, s);
    case 16: return launch<16>(x, cd2, n, d, global, src, w2, s);
    case 32: return launch<32>(x, cd2, n, d, global, src, w2, s);
    default: return launch<0>(x, cd2, n, d, global, src, w2, s);
  }
}

// The largest n whose best_w2 the kernel keeps in shared memory.
extern "C" int repro_prim_mst_smem_max_n() { return SMEM_MAX / (int)sizeof(float); }
