// lune_filter.cu — exact lune emptiness of an edge list against every point.
//
// Replaces the TPU kernel repro/kernels/lune_filter.py::_lune_filter_kernel
// (Pallas; wrapper `lune_filter`, called through repro/kernels/ops.py::
// lune_nonempty from repro/core/rng.py::_exact_lune_pass, the exact variant's
// scan of the edges the cheap filter cascade left unresolved, Alg. 1 lines
// 22-26).
//
// Per edge (a, b) with squared weight w2, as the reference computes it:
//   inside = some point c, c not a and not b, with
//              max(mrd(a, c) + eps * (|a|^2 + |c|^2),
//                  mrd(b, c) + eps * (|b|^2 + |c|^2)) < w2,
//            mrd(p, c) = max(d2(p, c), cd2(p), cd2(c)),
//            d2(p, c)  = max(|p|^2 + |c|^2 - 2 p.c, 0)   (matmul form),
//            eps = 64 * 2^-23: noise can only keep an edge, never drop one.
// Endpoints are excluded by index, so a duplicate of a under another index
// counts.  An edge with w2 = -inf (the wrapper's padding) has nothing inside.
//
// What bounds it on the H100: operations.  Every (edge, point) pair costs two
// d-long dot products plus about a dozen compares and adds: at n = 16000 the
// scan of the unresolved edges of the exact fit is billions of pairs, while
// the points (n * (d + 1) * 4 bytes) sit in L2 and the edges are read once.
//
// Design.  On the TPU, grid axis 1 walks the point tiles in order and ORs
// into a revisited output block.  Here blocks run in no order, so a block
// owns a tile of edges, one thread per edge, and loops over all point tiles
// itself: no atomics, no second pass.  The block's endpoint coordinates sit
// in shared memory transposed, (d, BE), so a warp's reads are conflict-free;
// each point tile (coordinates, |c|^2, cd2(c)) is staged into shared memory
// with coalesced loads and read back as broadcasts.  An edge stops at the
// first point inside its lune (the verdict cannot change), and the block
// stops staging tiles once every edge of it is decided (__syncthreads_or).
// The launcher sizes BE and the point tile from d so that both fit in
// shared memory (d <= 256).  Arithmetic is float32 on the FMA pipes with
// no tensor cores (TF32's error would swamp the margin), and every sum
// runs in index order with __fmul_rn/__fadd_rn, which nvcc never contracts
// into an FMA, so the verdicts equal the plain PyTorch version bit for bit.
// Register-resident endpoints for small d, and tensor-core dot products in
// a split-precision scheme, are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kEps = 7.62939453125e-06f;  // 64 * 2^-23
constexpr int SMEM_DEFAULT = 48 * 1024;     // above this, dynamic smem needs an opt-in
constexpr int SMEM_EDGES = 96 * 1024;       // the (2, d, BE) endpoint tiles
constexpr int SMEM_MAX = 200 * 1024;        // of the 227 KB a block may have

__device__ __forceinline__ float mrd_plus_margin(float dot, float pn, float cn,
                                                 float cdp, float cdc) {
  const float t = __fadd_rn(pn, cn);
  const float d2 = fmaxf(__fsub_rn(t, __fmul_rn(2.f, dot)), 0.f);
  return __fadd_rn(fmaxf(fmaxf(d2, cdp), cdc), __fmul_rn(kEps, t));
}

__global__ void lune_filter_kernel(
    const float* __restrict__ ax, const float* __restrict__ bx,
    const float* __restrict__ acd, const float* __restrict__ bcd,
    const int* __restrict__ aidx, const int* __restrict__ bidx,
    const float* __restrict__ w2, int m, const float* __restrict__ pts,
    const float* __restrict__ pcd, int n, int d, int bc,
    int* __restrict__ out) {
  extern __shared__ float smem[];
  const int be = blockDim.x;
  float* sa = smem;           // (d, be): endpoint a of each edge, transposed
  float* sb = sa + d * be;    // (d, be): endpoint b
  float* sc = sb + d * be;    // (bc, d): point tile
  float* scn = sc + bc * d;   // (bc,):   |c|^2
  float* scd = scn + bc;      // (bc,):   cd2(c)

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * be;
  const int e = e0 + tid;
  const bool active = e < m;

  for (int k = tid; k < be * d; k += be) {
    const int r = k / d, j = k - r * d;
    const bool ok = e0 + r < m;
    sa[j * be + r] = ok ? ax[(size_t)(e0 + r) * d + j] : 0.f;
    sb[j * be + r] = ok ? bx[(size_t)(e0 + r) * d + j] : 0.f;
  }
  __syncthreads();
  float an = __fmul_rn(sa[tid], sa[tid]);
  float bn = __fmul_rn(sb[tid], sb[tid]);
  for (int j = 1; j < d; ++j) {
    an = __fadd_rn(an, __fmul_rn(sa[j * be + tid], sa[j * be + tid]));
    bn = __fadd_rn(bn, __fmul_rn(sb[j * be + tid], sb[j * be + tid]));
  }
  const float w = active ? w2[e] : -CUDART_INF_F;
  const float cda = active ? acd[e] : 0.f, cdb = active ? bcd[e] : 0.f;
  const int ia = active ? aidx[e] : -1, ib = active ? bidx[e] : -1;
  // w2 = -inf (padding) or NaN: nothing can lie inside, decided already
  bool open = active && w > -CUDART_INF_F;
  bool inside = false;

  for (int c0 = 0; c0 < n; c0 += bc) {
    // also the barrier before the previous tile is overwritten
    if (!__syncthreads_or(open)) break;
    const int rows = min(bc, n - c0);
    for (int k = tid; k < rows * d; k += be) sc[k] = pts[(size_t)c0 * d + k];
    for (int r = tid; r < rows; r += be) scd[r] = pcd[c0 + r];
    __syncthreads();
    for (int r = tid; r < rows; r += be) {
      float s = __fmul_rn(sc[r * d], sc[r * d]);
      for (int j = 1; j < d; ++j) s = __fadd_rn(s, __fmul_rn(sc[r * d + j], sc[r * d + j]));
      scn[r] = s;
    }
    __syncthreads();
    if (!open) continue;
    for (int r = 0; r < rows; ++r) {
      const float* c = sc + r * d;
      float dot_a = __fmul_rn(sa[tid], c[0]);
      float dot_b = __fmul_rn(sb[tid], c[0]);
      for (int j = 1; j < d; ++j) {
        dot_a = __fadd_rn(dot_a, __fmul_rn(sa[j * be + tid], c[j]));
        dot_b = __fadd_rn(dot_b, __fmul_rn(sb[j * be + tid], c[j]));
      }
      const float va = mrd_plus_margin(dot_a, an, scn[r], cda, scd[r]);
      const float vb = mrd_plus_margin(dot_b, bn, scn[r], cdb, scd[r]);
      const int ci = c0 + r;
      if (fmaxf(va, vb) < w && ci != ia && ci != ib) {
        inside = true;
        open = false;
        break;
      }
    }
  }
  if (active) out[e] = inside ? 1 : 0;
}

}  // namespace

// ax, bx: (m, d) f32 endpoint coordinates; acd, bcd: (m,) f32 cd2 of the
// endpoints; aidx, bidx: (m,) i32 endpoint indices; w2: (m,) f32; pts: (n, d)
// f32; pcd: (n,) f32; out: (m,) i32, 1 where some point lies inside.
// `block_e` threads per block (edges per block) and `block_c` points per
// tile are upper bounds: both shrink until the tiles fit shared memory.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_lune_filter(
    const float* ax, const float* bx, const float* acd, const float* bcd,
    const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
    const float* pcd, int n, int d, int block_e, int block_c, int* out,
    void* stream) {
  if (m < 1 || n < 1 || d < 1 || d > 256 || block_e < 32 || block_e > 1024 || block_c < 1)
    return (int)cudaErrorInvalidValue;
  int be = block_e - block_e % 32;  // whole warps
  while (be > 32 && 2 * d * be * (int)sizeof(float) > SMEM_EDGES) {
    be /= 2;
    be = be < 32 ? 32 : be - be % 32;
  }
  const int free_floats = SMEM_MAX / (int)sizeof(float) - 2 * d * be;
  int bc = free_floats / (d + 2);
  if (bc > block_c) bc = block_c;
  if (bc < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * d * be + bc * (d + 2)) * sizeof(float);
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        lune_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lune_filter_kernel<<<(m + be - 1) / be, be, smem, (cudaStream_t)stream>>>(
      ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, bc, out);
  return (int)cudaGetLastError();
}
