// norms_win32.cuh — |x|^2 of each row in XLA's windows of 32
// (kernels/ops.py::sum_sq_win32, xla_order.cuh's tree_sum order): the
// pre-pass of pairwise_topk.cu's d > 32 instances and the SBCN tiles' norms
// (kernels/sbcn_tile.py::point_norms).  No TPU kernel: the reference sums
// these norms in XLA ops.
//
// Bound by bytes: each row is read once.  A block stages `rows` whole rows
// (contiguous in x) into shared memory with coalesced 16-byte loads where
// d % 4 == 0, each row placed as XLA pads it ((32 W - d) / 2 zeros in front)
// with one spare float after every 32, so that window w of a row starts at
// 33 w and the block's windows, spread one a thread over all its threads,
// read shared memory without bank conflicts.  Each window is summed in index
// order, each square rounded; the window sums are then summed level by
// level in windows of 32 (one thread a window), until at most 32 are left,
// which one thread a row adds in order.  Every add is __fadd_rn and every
// square __fmul_rn, which nvcc never contracts.

#pragma once

#include <cuda_runtime.h>

constexpr int NORM_THREADS = 256;
constexpr int NORM_FLOATS = 12288;         // a block's staged floats: the default 48 KB of dynamic shared memory
constexpr int NORM_SMEM_MAX = 200 * 1024;  // a row too long for NORM_FLOATS opts in up to this

// the rows a block stages, and the floats a staged row takes
struct NormPlan {
  int windows, stride, rows;
  size_t smem;
};

inline NormPlan norm_plan(int n, int d) {
  NormPlan p;
  p.windows = (d + 31) / 32;
  p.stride = 33 * p.windows;
  const int per_row = p.stride + p.windows;  // the row and its window sums
  p.rows = NORM_FLOATS / per_row;
  if (p.rows < 1) p.rows = 1;
  if (p.rows > 64) p.rows = 64;
  if (p.rows > n) p.rows = n;
  // the window sums' later levels reuse the staged rows' space
  p.smem = (size_t)p.rows * per_row * sizeof(float);
  return p;
}

__global__ void __launch_bounds__(NORM_THREADS) norms_win32_kernel(const float* __restrict__ x, int n, int d,
                                                                   NormPlan p, float* __restrict__ out) {
  extern __shared__ __align__(16) float nsm[];  // rows x stride staged, then rows x windows sums
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * p.rows;
  const int rows = min(p.rows, n - row0);
  const int w_n = p.windows, pad = (32 * w_n - d) / 2;
  float* wsum = nsm + (size_t)p.rows * p.stride;
  const float* src = x + (size_t)row0 * d;
  const int total = rows * d;
  // stage: flat element f of the block's rows -> row f / d, padded position q
  if ((d & 3) == 0) {
    for (int f = 4 * t; f < total; f += 4 * NORM_THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(src + f);
      const int r = f / d, q = f % d + pad;  // d % 4 == 0: the four share a row
      float* dst = nsm + r * p.stride;
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[q + c + (q + c) / 32] = e[c];
    }
  } else {
    for (int f = t; f < total; f += NORM_THREADS) {
      const int r = f / d, q = f % d + pad;
      nsm[r * p.stride + q + q / 32] = src[f];
    }
  }
  __syncthreads();
  // first level: window g % w_n of row g / w_n, its real elements in order
  for (int g = t; g < rows * w_n; g += NORM_THREADS) {
    const int r = g / w_n, w = g % w_n;
    const int m0 = max(0, pad - 32 * w), m1 = min(32, d + pad - 32 * w);
    const float* s = nsm + r * p.stride + 33 * w;
    float acc = __fmul_rn(s[m0], s[m0]);
    for (int m = m0 + 1; m < m1; ++m) acc = __fadd_rn(acc, __fmul_rn(s[m], s[m]));
    wsum[g] = acc;
  }
  __syncthreads();
  // later levels: windows of 32 over the sums, padded in front as XLA pads them
  float* cur = wsum;
  float* nxt = nsm;  // the staged rows are no longer read
  int len = w_n;
  while (len > 32) {
    const int w2 = (len + 31) / 32, pad2 = (32 * w2 - len) / 2;
    for (int g = t; g < rows * w2; g += NORM_THREADS) {
      const int r = g / w2, v = g % w2;
      const int i0 = max(0, 32 * v - pad2), i1 = min(len, 32 * v + 32 - pad2);
      const float* s = cur + r * len;
      float acc = s[i0];
      for (int i = i0 + 1; i < i1; ++i) acc = __fadd_rn(acc, s[i]);
      nxt[g] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    len = w2;
  }
  // top level: at most 32 sums a row, added in order
  for (int r = t; r < rows; r += NORM_THREADS) {
    const float* s = cur + r * len;
    float acc = s[0];
    for (int i = 1; i < len; ++i) acc = __fadd_rn(acc, s[i]);
    out[row0 + r] = acc;
  }
}

inline int launch_norms(const float* x, int n, int d, float* out, cudaStream_t stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const NormPlan p = norm_plan(n, d);
  if (p.smem > (size_t)NORM_SMEM_MAX) return (int)cudaErrorInvalidValue;  // d > about 48000
  if (p.smem > (size_t)48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(norms_win32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  norms_win32_kernel<<<(n + p.rows - 1) / p.rows, NORM_THREADS, p.smem, stream>>>(x, n, d, p, out);
  return (int)cudaGetLastError();
}
