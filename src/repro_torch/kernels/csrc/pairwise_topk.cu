// pairwise_topk.cu — exact self-kNN: tiled squared distances + a per-row top-K.
//
// Replaces the TPU kernel repro/kernels/pairwise_topk.py::_pairwise_topk_kernel
// (Pallas; wrapper `pairwise_topk`, called from repro/kernels/ops.py::knn).
//
// What it computes, as the reference does: d2(q, k) = |q|^2 + |k|^2 - 2 q.k in
// float32, clamped at 0; self pairs masked to +inf; the K smallest (d2, idx)
// pairs of every row in ascending order.  Among equal d2 the lower index wins,
// as the reference's stable streaming merge orders them (its running state
// sits before each new key tile, and tiles arrive in ascending index).
//
// What bounds it on the H100: operations.  The distance sweep is n^2 * d FMAs
// (n = 16000, d = 8: 2.05e9) on the float32 pipes, 67 TFLOP/s at most; the
// bytes are n * d * 4 in and n * K * 8 out, negligible beside that.  The top-K
// adds one compare per (row, key) and a K-long compare-swap per accepted key.
//
// Design: one thread per query row, BQ = 128 rows per block.  The query tile
// (up to 200 KB of dynamic shared memory, so d <= 256) and key tiles of up to
// 128 rows are staged through shared memory with coalesced loads, so each key
// is read from device memory once per block and broadcast to every thread.
// Products are plain float32 FFMA: no tensor cores, hence no TF32, which the
// downstream tie tolerances do not allow for.  Each thread keeps its sorted
// (d2, idx) list of K <= 32 entries in registers: the insertion is a fully
// unrolled compare-swap pass, so every list index is a compile-time constant.
// The grid is only ceil(n / 128) blocks, a few warps per SM at n = 16000, so
// the sweep is latency-bound; splitting the key range over more blocks (with
// a merge pass), wgmma, TMA and a warp-cooperative top-K are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 128;
constexpr int KMAX = 32;
constexpr int KEY_TILE = 128;
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, dynamic smem needs an opt-in
constexpr int SMEM_MAX = 200 * 1024;     // of the 227 KB a block may have

__global__ void __launch_bounds__(BQ) pairwise_topk_kernel(
    const float* __restrict__ x, int n, int d, int k, int kt,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;            // (d, BQ): query tile, transposed (conflict-free)
  float* ks = qs + d * BQ;     // (kt, d): key tile
  float* kn = ks + kt * d;     // (kt,):   key norms

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + tid;

  for (int e = tid; e < BQ * d; e += BQ) {
    const int r = e / d, j = e - r * d;
    qs[j * BQ + r] = (row0 + r < n) ? x[(size_t)(row0 + r) * d + j] : 0.f;
  }
  __syncthreads();
  float qn = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = qs[j * BQ + tid];
    qn = fmaf(v, v, qn);
  }

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = -1;
  }
  float worst = CUDART_INF_F;

  for (int k0 = 0; k0 < n; k0 += kt) {
    const int rows = min(kt, n - k0);
    __syncthreads();  // the previous key tile is consumed
    for (int e = tid; e < rows * d; e += BQ) ks[e] = x[(size_t)k0 * d + e];
    __syncthreads();
    for (int r = tid; r < rows; r += BQ) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(ks[r * d + j], ks[r * d + j], s);
      kn[r] = s;
    }
    __syncthreads();
    if (row >= n) continue;
    for (int r = 0; r < rows; ++r) {
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot = fmaf(qs[j * BQ + tid], ks[r * d + j], dot);
      float d2 = fmaxf(qn + kn[r] - 2.f * dot, 0.f);
      const int col = k0 + r;
      if (col == row) d2 = CUDART_INF_F;
      if (!(d2 < worst)) continue;
      // insert (d2, col): carry it down the sorted list, swapping wherever
      // it orders before the entry; the last entry falls off
      float cd = d2;
      int ci = col;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          const bool lt = cd < bd[j] || (cd == bd[j] && ci < bi[j]);
          if (lt) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = cd;
            bi[j] = ci;
            cd = td;
            ci = ti;
          }
          if (j == k - 1) worst = bd[j];
        }
      }
    }
  }
  if (row < n) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        out_d[(size_t)row * k + j] = bd[j];
        out_i[(size_t)row * k + j] = bi[j];
      }
    }
  }
}

}  // namespace

// x: (n, d) float32 row-major; out_d: (n, k) float32; out_i: (n, k) int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_pairwise_topk(const float* x, int n, int d, int k,
                                   float* out_d, int* out_i, void* stream) {
  if (n < 2 || d < 1 || k < 1 || k > KMAX || k > n - 1) return (int)cudaErrorInvalidValue;
  const int free_floats = SMEM_MAX / (int)sizeof(float) - BQ * d;
  const int fit = free_floats / (d + 1);
  const int kt = fit < KEY_TILE ? fit : KEY_TILE;
  if (kt < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BQ * d + kt * d + kt) * sizeof(float);
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        pairwise_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pairwise_topk_kernel<<<(n + BQ - 1) / BQ, BQ, smem, (cudaStream_t)stream>>>(
      x, n, d, k, kt, out_d, out_i);
  return (int)cudaGetLastError();
}
