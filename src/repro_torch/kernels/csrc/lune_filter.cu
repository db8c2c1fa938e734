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
// scan of the unresolved edges of the exact fit is billions of operations,
// while the points (n * (d + 1) * 4 bytes) sit in L2 and the edges are read
// once.  The sums are unfused (below), so the FMA pipes run at half rate.
//
// Design.  On the TPU, grid axis 1 walks the point tiles in order and ORs
// into a revisited output block.  Here blocks run in no order, so a block
// owns a few edges, one warp each, and loops over all point tiles itself: no
// atomics, no second pass.  The 32 lanes of a warp split the edge's points:
// lane l tests point l of each 32-point round against the edge, whose
// endpoints sit in registers for the fixed widths d in {2, 4, 8, 16, 32} (a
// template per width, so the dot products unroll) and in shared memory
// otherwise (d <= 256).  Each point tile (coordinates, |c|^2, cd2(c)) is
// staged into shared memory by one thread per point, transposed in float4
// (float2 at d = 2) chunks, so a round's loads are 16 bytes a lane with no
// bank conflicts, and shared by the block's warps.  A warp stops at the first
// round in which any lane finds a point inside (__any_sync: the verdict is an
// OR over points, so it does not depend on which lane finds one), and the
// block stops staging tiles once every warp of it has decided
// (__syncthreads_or).  Arithmetic is float32 with no tensor cores (TF32's
// error would swamp the margin), and every sum runs in index order with
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA, so the
// verdicts equal the plain PyTorch version bit for bit.
//
// Above d = 256 a tile of 32 points no longer fits shared memory beside the
// warps' endpoints (d = 1536: 8 warps' endpoints alone are 96 KB), so the
// sliced instance streams d in slices of SLICE floats: for each tile of at
// most TILE points, each slice of the point rows and of the warps' endpoints
// is staged in turn, each lane carries the two dot products of each of its
// TILE / 32 points across the slices in registers, and the staging thread
// carries its point's |c|^2 in shared memory.  One accumulator runs on over
// the slices, so every sum is the same index-order chain as at any width.
// The rounds then test the finished tile as above, one verdict per edge.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float kEps = 7.62939453125e-06f;  // 64 * 2^-23
constexpr int SMEM_DEFAULT = 48 * 1024;     // above this, dynamic smem needs an opt-in
constexpr int SMEM_BUDGET = 96 * 1024;     // the point tile's share: two blocks per SM
constexpr int SMEM_MAX = 200 * 1024;        // of the 227 KB a block may have
constexpr int TILE = 256;                   // sliced instance: points per tile at most
constexpr int SLICE = 64;                   // sliced instance: floats of d per staged slice
constexpr int MAX_D_TILED = 256;            // above this width the sliced instance runs

template <int D>
__host__ __device__ constexpr int vec_width() { return D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1); }

__device__ __forceinline__ float mrd_plus_margin(float dot, float pn, float cn,
                                                 float cdp, float cdc) {
  const float t = __fadd_rn(pn, cn);
  const float d2 = fmaxf(__fsub_rn(t, __fmul_rn(2.f, dot)), 0.f);
  return __fadd_rn(fmaxf(fmaxf(d2, cdp), cdc), __fmul_rn(kEps, t));
}

// Stage point row `r` of the tile: coordinates into shared memory, transposed
// in chunks of V floats, and |c|^2 summed in index order, unfused.
template <int D>
__device__ __forceinline__ void stage_point(const float* __restrict__ src, int r, int bc, int d,
                                            float* sc, float* scn) {
  float s;
  if constexpr (D > 0) {
    constexpr int V = vec_width<D>();
    float v[D];
#pragma unroll
    for (int c = 0; c < D / V; ++c) {
      if constexpr (V == 4) {
        const float4 t = reinterpret_cast<const float4*>(src)[c];
        v[4 * c] = t.x, v[4 * c + 1] = t.y, v[4 * c + 2] = t.z, v[4 * c + 3] = t.w;
        reinterpret_cast<float4*>(sc)[c * bc + r] = t;
      } else {
        const float2 t = reinterpret_cast<const float2*>(src)[c];
        v[2 * c] = t.x, v[2 * c + 1] = t.y;
        reinterpret_cast<float2*>(sc)[c * bc + r] = t;
      }
    }
    s = __fmul_rn(v[0], v[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  } else {
    float v = src[0];
    sc[r] = v;
    s = __fmul_rn(v, v);
    for (int j = 1; j < d; ++j) {
      v = src[j];
      sc[j * bc + r] = v;
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
  }
  scn[r] = s;
}

template <int D>
__global__ void lune_filter_kernel(
    const float* __restrict__ ax, const float* __restrict__ bx,
    const float* __restrict__ acd, const float* __restrict__ bcd,
    const int* __restrict__ aidx, const int* __restrict__ bidx,
    const float* __restrict__ w2, int m, const float* __restrict__ pts,
    const float* __restrict__ pcd, int n, int d_rt, int bc,
    int* __restrict__ out) {
  constexpr int V = vec_width<D>();
  constexpr int DR = D > 0 ? D : 1;  // register extent of an endpoint
  const int d = D > 0 ? D : d_rt;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;           // (d / V, bc, V): point tile
  float* scn = sc + bc * d;   // (bc,): |c|^2
  float* scd = scn + bc;      // (bc,): cd2(c)
  float* se = scd + bc;       // (warps, 2, d): the warps' endpoints (generic d only)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = e < m;

  float pa[DR], pb[DR];
  float an, bn;
  if constexpr (D > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      pa[j] = active ? ax[(size_t)e * D + j] : 0.f;
      pb[j] = active ? bx[(size_t)e * D + j] : 0.f;
    }
    an = __fmul_rn(pa[0], pa[0]);
    bn = __fmul_rn(pb[0], pb[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) {
      an = __fadd_rn(an, __fmul_rn(pa[j], pa[j]));
      bn = __fadd_rn(bn, __fmul_rn(pb[j], pb[j]));
    }
  } else {
    float* sa = se + warp * 2 * d;
    for (int j = lane; j < d; j += 32) {
      sa[j] = active ? ax[(size_t)e * d + j] : 0.f;
      sa[d + j] = active ? bx[(size_t)e * d + j] : 0.f;
    }
    __syncwarp();
    an = __fmul_rn(sa[0], sa[0]);
    bn = __fmul_rn(sa[d], sa[d]);
    for (int j = 1; j < d; ++j) {
      an = __fadd_rn(an, __fmul_rn(sa[j], sa[j]));
      bn = __fadd_rn(bn, __fmul_rn(sa[d + j], sa[d + j]));
    }
  }
  const float w = active ? w2[e] : -CUDART_INF_F;
  const float cda = active ? acd[e] : 0.f, cdb = active ? bcd[e] : 0.f;
  const int ia = active ? aidx[e] : -1, ib = active ? bidx[e] : -1;
  // w2 = -inf (padding) or NaN: nothing can lie inside, decided already
  bool open = active && w > -CUDART_INF_F;  // warp-uniform
  bool inside = false;

  for (int c0 = 0; c0 < n; c0 += bc) {
    // also the barrier before the previous tile is overwritten
    if (!__syncthreads_or(open)) break;
    const int rows = min(bc, n - c0);
    for (int r = tid; r < rows; r += blockDim.x) {
      stage_point<D>(pts + (size_t)(c0 + r) * d, r, bc, d, sc, scn);
      scd[r] = pcd[c0 + r];
    }
    __syncthreads();
    if (!open) continue;
    for (int b = 0; b < rows; b += 32) {
      const int r = b + lane;
      float dot_a, dot_b;
      if constexpr (D > 0) {
        float c[D];
#pragma unroll
        for (int k = 0; k < D / V; ++k) {
          if constexpr (V == 4) {
            const float4 t = reinterpret_cast<const float4*>(sc)[k * bc + r];
            c[4 * k] = t.x, c[4 * k + 1] = t.y, c[4 * k + 2] = t.z, c[4 * k + 3] = t.w;
          } else {
            const float2 t = reinterpret_cast<const float2*>(sc)[k * bc + r];
            c[2 * k] = t.x, c[2 * k + 1] = t.y;
          }
        }
        dot_a = __fmul_rn(pa[0], c[0]);
        dot_b = __fmul_rn(pb[0], c[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) {
          dot_a = __fadd_rn(dot_a, __fmul_rn(pa[j], c[j]));
          dot_b = __fadd_rn(dot_b, __fmul_rn(pb[j], c[j]));
        }
      } else {
        const float* sa = se + warp * 2 * d;
        const float c_0 = sc[r];
        dot_a = __fmul_rn(sa[0], c_0);
        dot_b = __fmul_rn(sa[d], c_0);
        for (int j = 1; j < d; ++j) {
          const float cj = sc[j * bc + r];
          dot_a = __fadd_rn(dot_a, __fmul_rn(sa[j], cj));
          dot_b = __fadd_rn(dot_b, __fmul_rn(sa[d + j], cj));
        }
      }
      const float cn = scn[r], cdc = scd[r];
      const float va = mrd_plus_margin(dot_a, an, cn, cda, cdc);
      const float vb = mrd_plus_margin(dot_b, bn, cn, cdb, cdc);
      const int ci = c0 + r;
      const bool hit = r < rows && fmaxf(va, vb) < w && ci != ia && ci != ib;
      if (__any_sync(FULL, hit)) {
        inside = true;
        open = false;
        break;
      }
    }
  }
  if (active && lane == 0) out[e] = inside ? 1 : 0;
}

// The sliced instance, for any d: one warp per edge, d streamed in slices of
// SLICE floats through shared memory (see the note at the top); bc points a
// tile, a multiple of 32 up to TILE.
__global__ void lune_filter_sliced_kernel(
    const float* __restrict__ ax, const float* __restrict__ bx,
    const float* __restrict__ acd, const float* __restrict__ bcd,
    const int* __restrict__ aidx, const int* __restrict__ bidx,
    const float* __restrict__ w2, int m, const float* __restrict__ pts,
    const float* __restrict__ pcd, int n, int d, int bc,
    int* __restrict__ out) {
  constexpr int PER_LANE = TILE / 32;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // (SLICE, bc): the point tile's slice
  float* scn = sc + SLICE * bc;  // (bc,): |c|^2, carried over the slices
  float* scd = scn + bc;         // (bc,): cd2(c)
  float* se = scd + bc;          // (warps, 2, SLICE): the warps' endpoint slices

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = e < m;
  // |a|^2 and |b|^2: every lane runs the same chain (broadcast loads); -0 +
  // the first square is that square exactly
  float an = -0.f, bn = -0.f;
  if (active) {
    for (int j = 0; j < d; ++j) {
      const float va = ax[(size_t)e * d + j], vb = bx[(size_t)e * d + j];
      an = __fadd_rn(an, __fmul_rn(va, va));
      bn = __fadd_rn(bn, __fmul_rn(vb, vb));
    }
  }
  const float w = active ? w2[e] : -CUDART_INF_F;
  const float cda = active ? acd[e] : 0.f, cdb = active ? bcd[e] : 0.f;
  const int ia = active ? aidx[e] : -1, ib = active ? bidx[e] : -1;
  bool open = active && w > -CUDART_INF_F;  // warp-uniform
  bool inside = false;
  float* sa = se + warp * 2 * SLICE;

  for (int c0 = 0; c0 < n; c0 += bc) {
    // also the barrier before the previous tile is overwritten
    if (!__syncthreads_or(open)) break;
    const int rows = min(bc, n - c0);
    float dot_a[PER_LANE], dot_b[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) dot_a[i] = dot_b[i] = -0.f;
    for (int s0 = 0; s0 < d; s0 += SLICE) {
      const int ds = min(SLICE, d - s0);
      if (s0 > 0) __syncthreads();  // the previous slice is consumed
      for (int r = tid; r < rows; r += blockDim.x) {
        const float* src = pts + (size_t)(c0 + r) * d + s0;
        float cn = s0 == 0 ? -0.f : scn[r];
        for (int j = 0; j < ds; ++j) {
          const float v = src[j];
          sc[j * bc + r] = v;
          cn = __fadd_rn(cn, __fmul_rn(v, v));
        }
        scn[r] = cn;
        if (s0 == 0) scd[r] = pcd[c0 + r];
      }
      for (int j = lane; j < ds; j += 32) {
        sa[j] = active ? ax[(size_t)e * d + s0 + j] : 0.f;
        sa[SLICE + j] = active ? bx[(size_t)e * d + s0 + j] : 0.f;
      }
      __syncthreads();
      if (!open) continue;
      for (int j = 0; j < ds; ++j) {
        const float pa = sa[j], pb = sa[SLICE + j];
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
          if (i * 32 < bc) {
            const float c = sc[j * bc + i * 32 + lane];
            dot_a[i] = __fadd_rn(dot_a[i], __fmul_rn(pa, c));
            dot_b[i] = __fadd_rn(dot_b[i], __fmul_rn(pb, c));
          }
        }
      }
    }
    if (!open) continue;
    // the last slice's barrier made every |c|^2 whole
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (i * 32 >= rows) break;  // warp-uniform
      const int r = i * 32 + lane;
      const float cn = scn[r], cdc = scd[r];
      const float va = mrd_plus_margin(dot_a[i], an, cn, cda, cdc);
      const float vb = mrd_plus_margin(dot_b[i], bn, cn, cdb, cdc);
      const int ci = c0 + r;
      const bool hit = r < rows && fmaxf(va, vb) < w && ci != ia && ci != ib;
      if (__any_sync(FULL, hit)) {
        inside = true;
        open = false;
        break;
      }
    }
  }
  if (active && lane == 0) out[e] = inside ? 1 : 0;
}

int launch_sliced(const float* ax, const float* bx, const float* acd, const float* bcd,
                  const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
                  const float* pcd, int n, int d, int warps, int block_c, int* out,
                  cudaStream_t stream, int* occ) {
  const int bc = (block_c < TILE ? block_c : TILE) / 32 * 32;
  const size_t smem = (size_t)(SLICE * bc + 2 * bc + warps * 2 * SLICE) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      lune_filter_sliced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (occ != nullptr) {
    occ[1] = warps * 32, occ[2] = (int)smem, occ[3] = bc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, lune_filter_sliced_kernel, warps * 32, smem);
  }
  lune_filter_sliced_kernel<<<(m + warps - 1) / warps, warps * 32, smem, stream>>>(
      ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, bc, out);
  return (int)cudaGetLastError();
}

// Launches the <D> instance, or with `occ` set only reports its blocks per SM,
// threads per block, dynamic shared memory and point tile into occ[0..3].
template <int D>
int launch(const float* ax, const float* bx, const float* acd, const float* bcd,
           const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
           const float* pcd, int n, int d, int warps, int block_c, int* out,
           cudaStream_t stream, int* occ) {
  const int e_floats = D > 0 ? 0 : warps * 2 * d;
  int bc = (SMEM_BUDGET / (int)sizeof(float) - e_floats) / (d + 2);
  bc = (bc < block_c ? bc : block_c) / 32 * 32;
  bc = bc < 32 ? 32 : bc;
  const size_t smem = (size_t)(bc * (d + 2) + e_floats) * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        lune_filter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (occ != nullptr) {
    occ[1] = warps * 32, occ[2] = (int)smem, occ[3] = bc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, lune_filter_kernel<D>, warps * 32, smem);
  }
  lune_filter_kernel<D><<<(m + warps - 1) / warps, warps * 32, smem, stream>>>(
      ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, bc, out);
  return (int)cudaGetLastError();
}

int dispatch(const float* ax, const float* bx, const float* acd, const float* bcd,
             const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
             const float* pcd, int n, int d, int block_e, int block_c, int* out,
             void* stream, int* occ) {
  if (m < 1 || n < 1 || d < 1 || block_e < 1 || block_e > 32 || block_c < 32 ||
      reinterpret_cast<size_t>(pts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LUNE_ARGS ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, block_e, block_c, out, s, occ
  if (d > MAX_D_TILED) return launch_sliced(REPRO_LUNE_ARGS);
  switch (d) {
    case 2: return launch<2>(REPRO_LUNE_ARGS);
    case 4: return launch<4>(REPRO_LUNE_ARGS);
    case 8: return launch<8>(REPRO_LUNE_ARGS);
    case 16: return launch<16>(REPRO_LUNE_ARGS);
    case 32: return launch<32>(REPRO_LUNE_ARGS);
    default: return launch<0>(REPRO_LUNE_ARGS);
  }
#undef REPRO_LUNE_ARGS
}

}  // namespace

// ax, bx: (m, d) f32 endpoint coordinates; acd, bcd: (m,) f32 cd2 of the
// endpoints; aidx, bidx: (m,) i32 endpoint indices; w2: (m,) f32; pts: (n, d)
// f32, 16-byte aligned; pcd: (n,) f32; out: (m,) i32, 1 where some point lies
// inside.  `block_e` edges per block (one warp each, 1..32) and at most
// `block_c` points per tile (rounded down to a multiple of 32, and shrunk to
// 96 KB of shared memory but not below 32 points; above d = 256, at most
// 256 points a tile, streamed in slices of d).  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_lune_filter(
    const float* ax, const float* bx, const float* acd, const float* bcd,
    const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
    const float* pcd, int n, int d, int block_e, int block_c, int* out,
    void* stream) {
  return dispatch(ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, block_e, block_c, out,
                  stream, nullptr);
}

// The launch configuration the kernel takes for (d, block_e, block_c), without
// launching: occ = {blocks per SM, threads per block, dynamic shared memory
// bytes, point tile}.
extern "C" int repro_lune_filter_occupancy(int d, int block_e, int block_c, int* occ) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, nullptr,
                  nullptr, 1, d, block_e, block_c, nullptr, nullptr, occ);
}
