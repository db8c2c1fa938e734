// edge_cascade.cu — the fused per-edge filter cascade of the RNG build.
//
// Replaces the TPU kernel repro/kernels/fused_cascade.py::_edge_cascade_kernel
// (Pallas; dispatch `_edge_cascade_pallas`, called through `edge_cascade` from
// repro/core/rng.py::_build_fused, stage 1 with k_check = 2 and stage 2 with
// k_check = kmax - 1).
//
// Per edge (a, b), as the reference computes it:
//   d2   = |x_a - x_b|^2 in diff form;
//   w2   = max(cd2_a, cd2_b, d2);
//   cert = (w2 == max(cd2_a, cd2_b)), bit-exact by construction;
//   kill = some c among the first k_check stored neighbours of a or b, c not
//          an endpoint, lies strictly inside the lune:
//            max(mrd_own + eps*(|x_own|^2 + |x_c|^2),
//                mrd_oth + eps*(|x_oth|^2 + |x_c|^2)) < w2,
//          own-list d2 read from knn_d2, cross d2 recomputed in diff form,
//          eps = 64 * 2^-23.
//
// What bounds it on the H100: bytes.  Each edge gathers its endpoints and
// 2 * k_check neighbours (index, stored d2, coordinates, core distance) from
// device memory: about (2 + 2 k_check)(d + 1) floats, against some
// 4 k_check d flops.  The gathers are scattered, so the real limit is
// sectors touched, not bytes moved; the points (n * d * 4 bytes) fit in L2.
//
// Design: one thread per edge, gathering from x, knn_idx, knn_d2 and cd2k
// itself, with no (m, k * d) candidate slabs built beforehand as the TPU
// dispatch does: the contract is the four outputs.  Every sum of squares
// runs in index order, either unfused (__fmul_rn/__fadd_rn, which forbid
// FMA contraction) or as an fmaf chain, as the caller's `use_fma` flag says,
// so d2, w2 and the verdicts equal the plain PyTorch version bit for bit
// in both orders.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 7.62939453125e-06f;  // 64 * 2^-23

// acc + t * t, unfused or with one rounding; the first term of a sum is
// the rounded square in both orders.
__device__ __forceinline__ float add_sq(float acc, float t, bool use_fma) {
  return use_fma ? fmaf(t, t, acc) : __fadd_rn(acc, __fmul_rn(t, t));
}

__device__ __forceinline__ float sq_dist(const float* __restrict__ p,
                                         const float* __restrict__ q, int d,
                                         bool use_fma) {
  const float t0 = __fsub_rn(p[0], q[0]);
  float acc = __fmul_rn(t0, t0);
  for (int j = 1; j < d; ++j) acc = add_sq(acc, __fsub_rn(p[j], q[j]), use_fma);
  return acc;
}

__device__ __forceinline__ float sq_norm(const float* __restrict__ p, int d,
                                         bool use_fma) {
  float acc = __fmul_rn(p[0], p[0]);
  for (int j = 1; j < d; ++j) acc = add_sq(acc, p[j], use_fma);
  return acc;
}

__global__ void edge_cascade_kernel(
    const float* __restrict__ x, const float* __restrict__ cd2k,
    const int* __restrict__ knn_idx, const float* __restrict__ knn_d2,
    int d, int k_full, const int* __restrict__ ea, const int* __restrict__ eb,
    const unsigned char* __restrict__ valid, int m, int k_check, bool use_fma,
    int* __restrict__ killed, int* __restrict__ cert,
    float* __restrict__ d2_out, float* __restrict__ w2_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const bool v = valid[e] != 0;
  const int a = v ? ea[e] : 0;  // invalid slots read point 0; masked below
  const int b = v ? eb[e] : 0;
  const float* xa = x + (size_t)a * d;
  const float* xb = x + (size_t)b * d;

  const float d2 = sq_dist(xa, xb, d, use_fma);
  const float cda = cd2k[a], cdb = cd2k[b];
  const float mcd = fmaxf(cda, cdb);
  const float w2 = fmaxf(mcd, d2);
  const float an = sq_norm(xa, d, use_fma), bn = sq_norm(xb, d, use_fma);

  bool kill = false;
  for (int side = 0; side < 2; ++side) {
    const int own = side ? b : a;
    const float* oth_x = side ? xa : xb;
    const float own_cd = side ? cdb : cda, oth_cd = side ? cda : cdb;
    const float own_n = side ? bn : an, oth_n = side ? an : bn;
    const int* cand = knn_idx + (size_t)own * k_full;
    const float* cand_d2 = knn_d2 + (size_t)own * k_full;
    for (int j = 0; j < k_check; ++j) {
      const int c = cand[j];
      const float* xc = x + (size_t)c * d;
      const float cn = sq_norm(xc, d, use_fma);
      const float cdc = cd2k[c];
      const float d2_oth = sq_dist(oth_x, xc, d, use_fma);
      const float mrd_own = __fadd_rn(fmaxf(fmaxf(cand_d2[j], own_cd), cdc),
                                      __fmul_rn(kEps, __fadd_rn(own_n, cn)));
      const float mrd_oth = __fadd_rn(fmaxf(fmaxf(d2_oth, oth_cd), cdc),
                                      __fmul_rn(kEps, __fadd_rn(oth_n, cn)));
      kill |= (fmaxf(mrd_own, mrd_oth) < w2) && c != a && c != b;
    }
  }
  killed[e] = (kill && v) ? 1 : 0;
  cert[e] = (v && w2 == mcd) ? 1 : 0;
  d2_out[e] = d2;
  w2_out[e] = w2;
}

}  // namespace

// x: (n, d) f32; cd2k: (n,) f32; knn_idx: (n, k_full) i32; knn_d2: (n, k_full)
// f32; ea, eb: (m,) i32; valid: (m,) bool; use_fma: 0 or 1 (summation order);
// outputs (m,) i32, i32, f32, f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_edge_cascade(
    const float* x, const float* cd2k, const int* knn_idx, const float* knn_d2,
    int d, int k_full, const int* ea, const int* eb, const unsigned char* valid,
    int m, int k_check, int use_fma, int block, int* killed, int* cert,
    float* d2_out, float* w2_out, void* stream) {
  if (m < 1 || d < 1 || k_check < 0 || k_check > k_full || block < 32 || block > 1024)
    return (int)cudaErrorInvalidValue;
  edge_cascade_kernel<<<(m + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      x, cd2k, knn_idx, knn_d2, d, k_full, ea, eb, valid, m, k_check, use_fma != 0,
      killed, cert, d2_out, w2_out);
  return (int)cudaGetLastError();
}
