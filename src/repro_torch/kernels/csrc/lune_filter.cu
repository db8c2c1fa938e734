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
// Above d = 256 (the sliced instance) a point tile of 32 rows no longer
// fits shared memory beside the warps' endpoints, and a warp-per-edge walk
// is bound by its loads, not its arithmetic: one shared-memory load per
// multiply-add pair, point rows staged one float at a time by one thread
// each, and a block of 8 edges that holds one kept edge walks every point
// tile alone while its other warps idle.  What the function needs is small
// (d = 1536, 4000 edges x 4000 points: a kept edge against every point, a
// removed one up to its first inside point), so the design is about doing
// only that work, with loads that keep the FP32 pipes fed.  The work is a
// list of items, (group of 32 edges, tile of 64 points), in tile-major
// order, which persistent blocks (as many as fit on the card) claim one at
// a time from an atomic counter.  An item first drops its group's edges
// that are decided (a hit writes 1 into the verdict, which is an OR over
// points, so the order in which blocks find hits does not matter) and is
// skipped when none is open.  So most groups are done after their first
// tiles (most edges that have a point inside find one among the first few
// points), and the tiles of a group with kept edges, which must see every
// point, spread over every SM instead of one block's share.  The open
// edges are compacted: their endpoint rows are staged side by side (a, b,
// a, b, ...), so a thread holds both dot products of its (edge, point)
// pairs and decides them without an exchange; a thread takes one point of
// the tile and every fourth open edge, so the work of a tile spreads over
// all 256 threads however few edges stay open.  d streams in
// slices of 32 floats, k contiguous, copied with 16-byte cp.async (4-byte
// copies where d % 4 != 0) into two buffers; a thread reads its point and
// each edge's endpoints as float4 (the endpoints are the same for a warp: a
// broadcast).  |a|^2, |b|^2 and |c|^2 come from a pre-pass, once a call.
// Every sum is the same index-order chain of __fmul_rn/__fadd_rn as at any
// width, so the verdicts stay equal to the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float kEps = 7.62939453125e-06f;  // 64 * 2^-23
constexpr int SMEM_DEFAULT = 48 * 1024;     // above this, dynamic smem needs an opt-in
constexpr int SMEM_BUDGET = 96 * 1024;     // the point tile's share: two blocks per SM
constexpr int SMEM_MAX = 200 * 1024;        // of the 227 KB a block may have
constexpr int MAX_D_TILED = 256;            // above this width the sliced instance runs
// the sliced instance: SE edges a block, SP points a tile, SK floats of d a
// slice (SKP with the padding that keeps float4 loads conflict-free)
constexpr int SE = 32, SP = 64, SK = 32, SKP = SK + 4, S_THREADS = 256;
constexpr int S_ROWS = SP + 2 * SE;
constexpr size_t S_SMEM = (size_t)(2 * S_ROWS * SKP + 5 * SE) * sizeof(float) + (5 * SE + 2) * sizeof(int);
static_assert(S_THREADS == 4 * SP, "a thread takes one point and every fourth open edge");

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

// |a|^2, |b|^2 and |c|^2 of every endpoint and point row in index order,
// unfused: the sliced instance's pre-pass.  Row r of the 2 m + n is ax's
// (r < m), bx's, then pts'.  A warp takes 32 rows and stages 32 columns of
// them at a time, each row's 32 floats in one coalesced load, and lane l
// carries row l's chain through them; the next columns load while this
// lane sums.
__global__ void __launch_bounds__(128) sum_sq_seq_kernel(const float* __restrict__ ax, const float* __restrict__ bx,
                                                         const float* __restrict__ pts, int m, int n, int d,
                                                         float* __restrict__ out) {
  __shared__ float tile[4][32][33];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int rows = 2 * m + n, r0 = (blockIdx.x * 4 + wib) * 32;
  if (r0 >= rows) return;  // warp-uniform
  auto row_of = [&](int r) { return r < m ? ax + (size_t)r * d : r < 2 * m ? bx + (size_t)(r - m) * d
                                                                             : pts + (size_t)(r - 2 * m) * d; };
  float nxt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) nxt[i] = r0 + i < rows && lane < d ? row_of(r0 + i)[lane] : 0.f;
  float s = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32) {
#pragma unroll
    for (int i = 0; i < 32; ++i) tile[wib][i][lane] = nxt[i];
    __syncwarp();
    const int c1 = c0 + 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) nxt[i] = r0 + i < rows && c1 + lane < d ? row_of(r0 + i)[c1 + lane] : 0.f;
    const int w = min(32, d - c0);
    for (int j = 0; j < w; ++j) {
      const float v = tile[wib][lane][j];
      s = c0 + j == 0 ? __fmul_rn(v, v) : __fadd_rn(s, __fmul_rn(v, v));
    }
    __syncwarp();
  }
  if (r0 + lane < rows) out[r0 + lane] = s;
}

// The sliced instance (d > 256; see the note at the top).  Item i is the
// group i % groups (edges [SE g, SE g + SE)) against point tile i / groups;
// `norms` holds |a|^2 (m), |b|^2 (m), |c|^2 (n); `out` and `*next` start at 0.
__global__ void __launch_bounds__(S_THREADS, 2) lune_filter_sliced_kernel(
    const float* __restrict__ ax, const float* __restrict__ bx,
    const float* __restrict__ acd, const float* __restrict__ bcd,
    const int* __restrict__ aidx, const int* __restrict__ bidx,
    const float* __restrict__ w2, int m, const float* __restrict__ pts,
    const float* __restrict__ pcd, int n, int d, const float* __restrict__ norms,
    int* __restrict__ next, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                            // 2 x (SP point rows, 2 SE endpoint rows) x SKP
  float* e_an = stage + 2 * S_ROWS * SKP;         // per edge of the group: |a|^2, |b|^2, cd2(a),
  float* e_bn = e_an + SE;                        // cd2(b), w2, a, b
  float* e_cda = e_bn + SE;
  float* e_cdb = e_cda + SE;
  float* e_w = e_cdb + SE;
  int* e_ia = reinterpret_cast<int*>(e_w + SE);
  int* e_ib = e_ia + SE;
  int* open = e_ib + SE;                          // (SE,): still open
  int* hit = open + SE;                           // (SE,): a point of this tile lies inside
  int* olist = hit + SE;                          // the open edges, compacted; their count; the item
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = tid % SP, q = tid / SP;           // the thread's point, and its open edges q, q + 4, ...
  const int groups = (m + SE - 1) / SE, items = groups * ((n + SP - 1) / SP);
  const int n_slices = (d + SK - 1) / SK;
  const bool vec = (d & 3) == 0;  // rows start on 16 bytes: 16-byte copies

  for (;;) {
    __syncthreads();  // the previous item is done with shared memory
    if (tid == 0) olist[SE + 1] = atomicAdd(next, 1);
    __syncthreads();
    const int item = olist[SE + 1];
    if (item >= items) break;
    const int e0 = item % groups * SE, c0 = item / groups * SP;
    if (tid < SE) {
      // the group's edges still open: not padding (w2 = -inf) or NaN, and
      // not decided by an earlier item (`out` only ever turns 1)
      const int e = e0 + tid;
      const bool o = e < m && w2[e] > -CUDART_INF_F && __ldcg(out + e) == 0;
      if (o) {
        e_an[tid] = norms[e], e_bn[tid] = norms[m + e];
        e_cda[tid] = acd[e], e_cdb[tid] = bcd[e], e_w[tid] = w2[e];
        e_ia[tid] = aidx[e], e_ib[tid] = bidx[e];
      }
      open[tid] = o;
      hit[tid] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      int base = 0;
      for (int c = 0; c < SE; c += 32) {
        const unsigned msk = __ballot_sync(FULL, open[c + lane] != 0);
        if (open[c + lane]) olist[base + __popc(msk & ((1u << lane) - 1u))] = c + lane;
        base += __popc(msk);
      }
      if (lane == 0) olist[SE] = base;
    }
    __syncthreads();
    const int n_open = olist[SE];
    if (n_open == 0) continue;  // every edge of the group is decided
    const int mine = q < n_open ? (n_open - 1 - q) / 4 + 1 : 0;  // warp-uniform

    // stage the slice [s0, s0 + SK) of the tile's points and of the open
    // edges' endpoints (a, b, a, b, ...) into buffer b
    auto issue = [&](int b, int s0) {
      float* dst = stage + b * S_ROWS * SKP;
      const int rows = SP + 2 * n_open;
      auto src_of = [&](int r, int col, bool& ok) -> const float* {
        if (r < SP) {
          ok = c0 + r < n && col < d;
          return pts + (size_t)(c0 + r) * d + col;
        }
        ok = col < d;
        const int e = e0 + olist[(r - SP) >> 1];
        return ((r - SP) & 1 ? bx : ax) + (size_t)e * d + col;
      };
      if (vec) {
        for (int c = tid; c < rows * (SK / 4); c += S_THREADS) {
          const int r = c / (SK / 4), col = c % (SK / 4) * 4;
          bool ok;
          const float* src = src_of(r, s0 + col, ok);
          cp_async16(dst + r * SKP + col, ok ? src : pts, ok);
        }
      } else {
        for (int c = tid; c < rows * SK; c += S_THREADS) {
          const int r = c / SK, col = c % SK;
          bool ok;
          const float* src = src_of(r, s0 + col, ok);
          cp_async4(dst + r * SKP + col, ok ? src : pts, ok);
        }
      }
      cp_async_commit();
    };

    float dot_a[SE / 4], dot_b[SE / 4];
#pragma unroll
    for (int j = 0; j < SE / 4; ++j) dot_a[j] = dot_b[j] = -0.f;  // -0 + the first product is that product
    issue(0, 0);
    for (int s = 0; s < n_slices; ++s) {
      if (s + 1 < n_slices) {
        issue((s + 1) & 1, (s + 1) * SK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* sp = stage + (s & 1) * S_ROWS * SKP + p * SKP;
      const float* se = stage + (s & 1) * S_ROWS * SKP + (SP + 2 * q) * SKP;  // edge q + 4 j at + 8 j SKP
      const int ds = min(SK, d - s * SK);
      if (ds == SK) {
#pragma unroll
        for (int kk = 0; kk < SK; kk += 4) {
          const float4 c = *reinterpret_cast<const float4*>(sp + kk);
#pragma unroll
          for (int j = 0; j < SE / 4; ++j) {
            if (j < mine) {
              const float4 a = *reinterpret_cast<const float4*>(se + 8 * j * SKP + kk);
              const float4 b = *reinterpret_cast<const float4*>(se + (8 * j + 1) * SKP + kk);
              dot_a[j] = __fadd_rn(dot_a[j], __fmul_rn(a.x, c.x));
              dot_b[j] = __fadd_rn(dot_b[j], __fmul_rn(b.x, c.x));
              dot_a[j] = __fadd_rn(dot_a[j], __fmul_rn(a.y, c.y));
              dot_b[j] = __fadd_rn(dot_b[j], __fmul_rn(b.y, c.y));
              dot_a[j] = __fadd_rn(dot_a[j], __fmul_rn(a.z, c.z));
              dot_b[j] = __fadd_rn(dot_b[j], __fmul_rn(b.z, c.z));
              dot_a[j] = __fadd_rn(dot_a[j], __fmul_rn(a.w, c.w));
              dot_b[j] = __fadd_rn(dot_b[j], __fmul_rn(b.w, c.w));
            }
          }
        }
      } else {  // the last slice of a ragged d: only the floats below d
        for (int kk = 0; kk < ds; ++kk) {
          const float c = sp[kk];
#pragma unroll
          for (int j = 0; j < SE / 4; ++j) {
            if (j < mine) {
              dot_a[j] = __fadd_rn(dot_a[j], __fmul_rn(se[8 * j * SKP + kk], c));
              dot_b[j] = __fadd_rn(dot_b[j], __fmul_rn(se[(8 * j + 1) * SKP + kk], c));
            }
          }
        }
      }
      __syncthreads();  // buffer s & 1 is free for slice s + 2
    }
    const int ci = c0 + p;
    if (ci < n) {
      const float cn = norms[2 * m + ci], cdc = pcd[ci];
#pragma unroll
      for (int j = 0; j < SE / 4; ++j) {
        if (j < mine) {
          const int l = olist[q + 4 * j];
          const float va = mrd_plus_margin(dot_a[j], e_an[l], cn, e_cda[l], cdc);
          const float vb = mrd_plus_margin(dot_b[j], e_bn[l], cn, e_cdb[l], cdc);
          if (fmaxf(va, vb) < e_w[l] && ci != e_ia[l] && ci != e_ib[l]) hit[l] = 1;
        }
      }
    }
    __syncthreads();
    if (tid < SE && hit[tid]) out[e0 + tid] = 1;
  }
}

// The sliced instance: the norms' pre-pass, then as many persistent blocks
// as fit on the card.
int launch_sliced(const float* ax, const float* bx, const float* acd, const float* bcd,
                  const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
                  const float* pcd, int n, int d, int* out, cudaStream_t stream, int* occ, void* work,
                  size_t* work_bytes) {
  const size_t norm_floats = (size_t)2 * m + n;
  if (work_bytes != nullptr) {
    *work_bytes = (norm_floats + 1) * sizeof(float);  // the norms, and the item counter
    return 0;
  }
  cudaError_t err = cudaFuncSetAttribute(lune_filter_sliced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S_SMEM);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lune_filter_sliced_kernel, S_THREADS, S_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (occ != nullptr) {
    occ[0] = per_sm, occ[1] = S_THREADS, occ[2] = (int)S_SMEM, occ[3] = SP;
    return 0;
  }
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  const long items = (long)((m + SE - 1) / SE) * ((n + SP - 1) / SP);
  const long slots = (long)(per_sm > 0 ? per_sm : 1) * sms;
  float* norms = static_cast<float*>(work);
  int* next = reinterpret_cast<int*>(norms + norm_floats);
  if ((err = cudaMemsetAsync(out, 0, (size_t)m * sizeof(int), stream)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess) return (int)err;
  sum_sq_seq_kernel<<<(2 * m + n + 127) / 128, 128, 0, stream>>>(ax, bx, pts, m, n, d, norms);
  lune_filter_sliced_kernel<<<(int)(items < slots ? items : slots), S_THREADS, S_SMEM, stream>>>(
      ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, norms, next, out);
  return (int)cudaGetLastError();
}

// Launches the <D> instance, or with `occ` set only reports its blocks per SM,
// threads per block, dynamic shared memory and point tile into occ[0..3].
template <int D>
int launch(const float* ax, const float* bx, const float* acd, const float* bcd,
           const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
           const float* pcd, int n, int d, int warps, int block_c, int* out,
           cudaStream_t stream, int* occ, size_t* work_bytes) {
  if (work_bytes != nullptr) {
    *work_bytes = 0;
    return 0;
  }
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
             void* stream, int* occ, void* work, size_t* work_bytes) {
  if (m < 1 || n < 1 || d < 1 || block_e < 1 || block_e > 32 || block_c < 32 ||
      reinterpret_cast<size_t>(pts) % 16 != 0 || reinterpret_cast<size_t>(ax) % 16 != 0 ||
      reinterpret_cast<size_t>(bx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LUNE_ARGS ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, block_e, block_c, out, s, occ, work_bytes
  if (d > MAX_D_TILED)
    return launch_sliced(ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, out, s, occ, work, work_bytes);
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

// ax, bx: (m, d) f32 endpoint coordinates, 16-byte aligned; acd, bcd: (m,)
// f32 cd2 of the endpoints; aidx, bidx: (m,) i32 endpoint indices; w2: (m,)
// f32; pts: (n, d) f32, 16-byte aligned; pcd: (n,) f32; out: (m,) i32, 1
// where some point lies inside; work: repro_lune_filter_workspace bytes
// (null where that is 0).  Up to d = 256, `block_e` edges per block (one
// warp each, 1..32) and at most `block_c` points per tile (rounded down to
// a multiple of 32, and shrunk to 96 KB of shared memory but not below 32
// points); above d = 256 the tiles are fixed (32 edges an item, 64 points a
// tile, d in slices of 32) and the two only have to be valid.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_lune_filter(
    const float* ax, const float* bx, const float* acd, const float* bcd,
    const int* aidx, const int* bidx, const float* w2, int m, const float* pts,
    const float* pcd, int n, int d, int block_e, int block_c, int* out,
    void* work, void* stream) {
  return dispatch(ax, bx, acd, bcd, aidx, bidx, w2, m, pts, pcd, n, d, block_e, block_c, out,
                  stream, nullptr, work, nullptr);
}

// The workspace the launch for (m, n, d) needs, in bytes.
extern "C" int repro_lune_filter_workspace(int m, int n, int d, size_t* bytes) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, m, nullptr,
                  nullptr, n, d, 8, 512, nullptr, nullptr, nullptr, nullptr, bytes);
}

// The launch configuration the kernel takes for (d, block_e, block_c), without
// launching: occ = {blocks per SM, threads per block, dynamic shared memory
// bytes, point tile}.
extern "C" int repro_lune_filter_occupancy(int d, int block_e, int block_c, int* occ) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, nullptr,
                  nullptr, 1, d, block_e, block_c, nullptr, nullptr, occ, nullptr, nullptr);
}
