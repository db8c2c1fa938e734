// sbcn_tile.cu — the SBCN emission's tile products in the reference's
// float32 order, for widths above 256 (kernels/sbcn_tile.py).
//
// The reference's SBCN tiers take |x_a|^2 + |x_b|^2 - 2 x_a.x_b over
// (P, A, d) x (P, B, d) gathered rows.  On the CPU, XLA hands the dot to
// YNNPACK, whose kernel, and so whose order, depends on the tile's (A, B).
// d is cut into PANEL-deep slices (one slice where PANEL = 0), and each
// slice is summed the same way:
//   * LANES chains: lane r sums the slice's products k = r (mod LANES) as
//     one FMA chain; the lanes are added pairwise ((l0+l1)+(l2+l3)...) or,
//     with HALVE, each with the one LANES/2 away, level by level;
//   * the slice's last (length % LANES) products, its tail, are summed in
//     order (an FMA chain with 8 lanes, unfused adds otherwise) and added
//     after the lanes;
// and the slices' sums are added in order.  Every add is __fadd_rn and
// every product __fmul_rn or fmaf, which nvcc never contracts or
// reassociates.  The norms come from pairwise_topk.cu's pre-pass, in
// XLA's windows of 32 (xla_order.cuh).
//
// One thread computes one (pair, a, b) cell.  A block stages the rows of
// PPB pairs' (TA, TB) tiles through shared memory 32 columns at a time;
// small tiers pack several pairs into a block.

#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;          // columns staged a step
constexpr int ROW = KC + 1;     // padded row stride: no bank conflicts across rows
constexpr int THREADS = 256;
constexpr int TILE = 16;        // cells a side of a tile past 16 rows or columns
constexpr int SMEM_MAX = 48 * 1024;  // the default dynamic shared memory of a block

template <int L, bool HALVE>
__device__ __forceinline__ float reduce_lanes(const float* acc) {
  if constexpr (L == 1) {
    return acc[0];
  } else if constexpr (L == 2) {
    return __fadd_rn(acc[0], acc[1]);
  } else if constexpr (L == 4) {
    return HALVE ? __fadd_rn(__fadd_rn(acc[0], acc[2]), __fadd_rn(acc[1], acc[3]))
                 : __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
  } else {
    if (HALVE) {
      const float b0 = __fadd_rn(acc[0], acc[4]), b1 = __fadd_rn(acc[1], acc[5]);
      const float b2 = __fadd_rn(acc[2], acc[6]), b3 = __fadd_rn(acc[3], acc[7]);
      return __fadd_rn(__fadd_rn(b0, b2), __fadd_rn(b1, b3));
    }
    return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
                     __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
  }
}

struct Tiling {
  int ta, tb, ppb, tiles_b, tiles_per_pair, groups;
};

Tiling tiling(int P, int A, int B) {
  Tiling t;
  t.ta = A < TILE ? A : TILE;
  t.tb = B < TILE ? B : TILE;
  t.ppb = (A <= TILE && B <= TILE) ? THREADS / (t.ta * t.tb) : 1;
  const int fit = SMEM_MAX / ((t.ta + t.tb) * ROW * (int)sizeof(float));
  if (t.ppb > fit) t.ppb = fit;  // (1, 2) tiers: 124 pairs a block, not 128
  t.tiles_b = (B + t.tb - 1) / t.tb;
  t.tiles_per_pair = ((A + t.ta - 1) / t.ta) * t.tiles_b;
  t.groups = (P + t.ppb - 1) / t.ppb;
  return t;
}

template <int L, bool HALVE>
__global__ void __launch_bounds__(THREADS) sbcn_dot_kernel(
    const float* __restrict__ x, int d, const int* __restrict__ a_idx, const int* __restrict__ b_idx, int P, int A,
    int B, Tiling tl, int panel, float* __restrict__ out) {
  extern __shared__ float smem[];  // ppb pairs x (ta + tb) rows x ROW
  const int item = blockIdx.x;
  const int group = item / tl.tiles_per_pair, tile = item % tl.tiles_per_pair;
  const int ti = tile / tl.tiles_b, tj = tile % tl.tiles_b;
  const int cells = tl.ta * tl.tb, rows = tl.ta + tl.tb;
  const int t = threadIdx.x;
  const int lp = t / cells, c = t % cells, i = c / tl.tb, j = c % tl.tb;
  const int p = group * tl.ppb + lp;
  const int ia = ti * tl.ta + i, jb = tj * tl.tb + j;
  const bool active = lp < tl.ppb && p < P && ia < A && jb < B;
  const int pl = panel > 0 ? panel : d;  // the slices' depth: a multiple of KC, or all of d
  float acc[L];
#pragma unroll
  for (int r = 0; r < L; ++r) acc[r] = 0.f;
  float tail = 0.f, total = 0.f;
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int e = t; e < tl.ppb * rows * KC; e += blockDim.x) {
      const int q = e / (rows * KC), r = (e / KC) % rows, kk = e % KC;
      const int pp = group * tl.ppb + q;
      float v = 0.f;
      if (pp < P && k0 + kk < d) {
        int id = 0;
        if (r < tl.ta) {
          const int ra = ti * tl.ta + r;
          if (ra < A) id = a_idx[(size_t)pp * A + ra];
        } else {
          const int rb = tj * tl.tb + (r - tl.ta);
          if (rb < B) id = b_idx[(size_t)pp * B + rb];
        }
        v = x[(size_t)(id < 0 ? 0 : id) * d + k0 + kk];  // padded ids read row 0, as the plain version
      }
      smem[(q * rows + r) * ROW + kk] = v;
    }
    __syncthreads();
    if (active) {
      const float* sa = smem + (lp * rows + i) * ROW;
      const float* sb = smem + (lp * rows + tl.ta + j) * ROW;
      const int p0 = k0 - k0 % pl, pend = min(d, p0 + pl);  // the staged columns lie in one slice
      const int mend = pend - (pend - p0) % L;  // the slice's lanes take [p0, mend), its tail the rest
      for (int kk = 0; kk < KC; kk += L) {
#pragma unroll
        for (int r = 0; r < L; ++r) {
          const int k = k0 + kk + r;
          if (k >= d) break;
          const float av = sa[kk + r], bv = sb[kk + r];
          if (k < mend) {
            acc[r] = k - p0 < L ? __fmul_rn(av, bv) : fmaf(av, bv, acc[r]);
          } else if (k == mend) {
            tail = __fmul_rn(av, bv);
          } else {
            tail = L == 8 ? fmaf(av, bv, tail) : __fadd_rn(tail, __fmul_rn(av, bv));
          }
          if (k == pend - 1) {
            float s = mend > p0 ? reduce_lanes<L, HALVE>(acc) : tail;
            if (mend > p0 && mend < pend) s = __fadd_rn(s, tail);
            total = p0 == 0 ? s : __fadd_rn(total, s);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  if (a_idx[(size_t)p * A + ia] < 0 || b_idx[(size_t)p * B + jb] < 0) {
    out[((size_t)p * A + ia) * B + jb] = 0.f;  // a padded cell, masked by the caller
    return;
  }
  out[((size_t)p * A + ia) * B + jb] = total;
}

template <int L, bool HALVE>
int launch_dot(const float* x, int d, const int* a_idx, const int* b_idx, int P, int A, int B, int panel, float* out,
               cudaStream_t s) {
  const Tiling tl = tiling(P, A, B);
  const size_t smem = (size_t)tl.ppb * (tl.ta + tl.tb) * ROW * sizeof(float);
  const long long blocks = (long long)tl.groups * tl.tiles_per_pair;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sbcn_dot_kernel<L, HALVE><<<(unsigned)blocks, THREADS, smem, s>>>(x, d, a_idx, b_idx, P, A, B, tl, panel, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) f32; a_idx (P, A), b_idx (P, B) i32 point ids, -1 padded;
// out: (P, A, B) f32 dot products in the order (lanes, halve, panel)
// described at the top, 0 on padded cells.  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for an order it has no instance of (or a
// panel that is not a multiple of KC).
extern "C" int repro_sbcn_tile_dots(const float* x, int d, const int* a_idx, const int* b_idx, int P, int A, int B,
                                    int lanes, int halve, int panel, float* out, void* stream) {
  if (P < 1 || A < 1 || B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (panel < 0 || panel % KC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1 && !halve) return launch_dot<1, false>(x, d, a_idx, b_idx, P, A, B, panel, out, s);
  if (lanes == 2 && !halve) return launch_dot<2, false>(x, d, a_idx, b_idx, P, A, B, panel, out, s);
  if (lanes == 4) {
    return halve ? launch_dot<4, true>(x, d, a_idx, b_idx, P, A, B, panel, out, s)
                 : launch_dot<4, false>(x, d, a_idx, b_idx, P, A, B, panel, out, s);
  }
  if (lanes == 8) {
    return halve ? launch_dot<8, true>(x, d, a_idx, b_idx, P, A, B, panel, out, s)
                 : launch_dot<8, false>(x, d, a_idx, b_idx, P, A, B, panel, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
