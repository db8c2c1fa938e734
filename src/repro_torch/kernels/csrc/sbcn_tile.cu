// sbcn_tile.cu — the SBCN emission's tile products in the reference's
// float32 order, for widths above 256 (kernels/sbcn_tile.py).  No TPU
// kernel: the reference computes them in XLA ops (src/repro/core/sbcn.py:53
// and :109), whose order the port must keep for its candidates to be the
// reference's at near-ties.
//
// The order (kernels/sbcn_tile.py::dot_order, read from XLA's output):
//   * LANES chains over the first main = d - d % LANES products: lane r
//     sums products k = r (mod LANES) as one FMA chain inside PANEL-deep
//     slices (one slice where PANEL = 0); at each slice's end the lanes are
//     added pairwise ((l0+l1)+(l2+l3)...) or, with HALVE, each with the one
//     LANES/2 away, level by level, and the slice sums are added in order;
//     the last d % LANES products, the tail, are summed in order (an FMA
//     chain with 8 lanes, unfused adds otherwise) and added last;
//   * LANES = 0: XLA's own loop over a [d] x [B, d] product (loop_dot).
// Every add is __fadd_rn and every product __fmul_rn or fmaf, which nvcc
// never contracts or reassociates.  A lane starts from -0, so that its first
// fmaf is its first product, rounded, with its sign.
//
// Bound by operations: 2 d a real cell.  The kernel reads its operands from
// shared memory, so a cell's FMA costs two shared loads where the rows are
// not reused in registers.  Four paths, chosen by the wrapper:
//   * bucketed (any order with lanes): the call's real cells are counted
//     into buckets of (a_id / T, b_id / T), T = 128 rows, and scattered into
//     one list by bucket and, up to 8192 buckets (n <= 11520), by a-row
//     within it, so that a quarter-warp's cells share or neighbour their
//     a-rows (small kernels on the device, no host sync; a block counts
//     and places its cells in shared memory first where the keys are few).
//     Work items of at most CAP cells of one bucket go to persistent blocks;
//     a block stages the bucket's two 128-row tiles of x (one, on the
//     diagonal) through a 3-stage ring of 32-column stages (cp.async, one
//     mbarrier a stage for the landed copies and one for the readers), so
//     each row of x is read once a bucket, not once a pair.  A thread owns
//     C cells, each with its LANES accumulators in registers (C x LANES <=
//     32), and reads their rows as float4 at a padded row stride;
//   * dense (one lane, at least 32 x 64 cells a pair: the row path's and
//     _sbcn_large's chunks): a block takes a 64 x 64 block of one pair's
//     cells, a thread a 4 x 4 block of them, one accumulator each, and
//     reuses its a and b fragments from registers (16 FMAs for two float4
//     shared loads);
//   * loop (LANES = 0) and direct (lanes, past NT_MAX tiles of points): a
//     thread a cell, its rows read from global memory.
// Tensor cores stay out: TF32 or wgmma would change the order.

#include <cuda_runtime.h>

#include "stage_ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int T = 128;                 // rows of a bucket's tile
constexpr int KC = 32;                 // columns a stage
constexpr int ROW = KC + 4;            // padded row stride: float4 reads of 8 rows spread over the banks
constexpr int STAGES = 3;
constexpr int TILE_FLOATS = T * ROW;
constexpr int STAGE_FLOATS = 2 * TILE_FLOATS;
constexpr int NT_MAX = 1024;           // tiles a side of the bucket grid (n <= 131072); past it the direct path
constexpr int HIST_MAX = 4096;         // keys counted in shared memory first
constexpr long long SUB_KEYS_MAX = 1 << 20;  // keys (bucket, a-row) at most; past them a key a bucket
constexpr size_t BUCKET_SMEM =
    2 * STAGES * sizeof(unsigned long long) + (size_t)STAGES * STAGE_FLOATS * sizeof(float);
constexpr int DT = 64;                 // the dense path: cells a side of a block
constexpr int DROW = DT + 4;
constexpr int PATH_LOOP = 0, PATH_DENSE = 1, PATH_BUCKETED = 2, PATH_DIRECT = 3;

template <int L>
__host__ __device__ constexpr int cells_per_thread() { return L == 8 ? 4 : 8; }

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

// the end of the slice that column k lies in, within the main products
__device__ __forceinline__ int slice_end(int k, int panel, int main) {
  return panel > 0 ? min(main, (k / panel + 1) * panel) : main;
}

// ---------------------------------------------------------------------------
// bucketing: count, plan, scatter

// A cell's key: its bucket (a_id / T, b_id / T), times `sub`, plus its
// a-row within the bucket's tile where sub = T (the list then holds a
// bucket's cells by a-row, so a quarter-warp's cells share or neighbour
// their a-rows); -1 for a padded cell.
__device__ __forceinline__ int cell_key(const int* __restrict__ a_idx, const int* __restrict__ b_idx, int A, int B,
                                        int c, int nt, int sub) {
  const int p = c / (A * B), r = c % (A * B);
  const int ia = a_idx[p * A + r / B], ib = b_idx[p * B + r % B];
  if (ia < 0 || ib < 0) return -1;
  return ((ia / T) * nt + ib / T) * sub + (sub > 1 ? ia % T : 0);
}

// Counts the real cells of each key, and writes 0 to the padded ones.  Up
// to HIST_MAX keys a block counts its cells in shared memory first, so that
// a key's global counter takes one atomic a block, not one a cell.
__global__ void __launch_bounds__(THREADS) bucket_count_kernel(const int* __restrict__ a_idx,
                                                              const int* __restrict__ b_idx, int A, int B, int cells,
                                                              int nt, int sub, int* __restrict__ count,
                                                              float* __restrict__ out) {
  __shared__ int hist[HIST_MAX];
  const int nk = nt * nt * sub;
  const bool local = nk <= HIST_MAX;
  if (local) {
    for (int k = threadIdx.x; k < nk; k += THREADS) hist[k] = 0;
    __syncthreads();
  }
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cells; c += gridDim.x * THREADS) {
    const int key = cell_key(a_idx, b_idx, A, B, c, nt, sub);
    if (key < 0) {
      out[c] = 0.f;  // a padded cell, masked by the caller
    } else {
      atomicAdd(local ? &hist[key] : &count[key], 1);
    }
  }
  if (local) {
    __syncthreads();
    for (int k = threadIdx.x; k < nk; k += THREADS)
      if (hist[k]) atomicAdd(&count[k], hist[k]);
  }
}

// T threads a bucket, the blocks striding over the buckets: each sub-key's
// first place within its bucket (exclusive scan of the bucket's counts) and
// the bucket's cells.
__global__ void __launch_bounds__(T) bucket_sub_scan_kernel(const int* __restrict__ count, int nb,
                                                           int* __restrict__ sub_off, int* __restrict__ bucket_cells) {
  __shared__ int s_sub[T];
  const int t = threadIdx.x;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const int k = b * T + t, v = count[k];
    s_sub[t] = v;
    __syncthreads();
    for (int off = 1; off < T; off <<= 1) {  // inclusive scan
      const int x = t >= off ? s_sub[t - off] : 0;
      __syncthreads();
      s_sub[t] += x;
      __syncthreads();
    }
    sub_off[k] = s_sub[t] - v;
    if (t == T - 1) bucket_cells[b] = s_sub[t];
    __syncthreads();
  }
}

// One block: start[] = exclusive scan of the buckets' cells; the work items
// (CAP cells of a bucket at most), the first of each bucket and each item's
// bucket.
__global__ void __launch_bounds__(1024) bucket_plan_kernel(const int* __restrict__ cells_of, int nb, int cap,
                                                          int* __restrict__ start, int* __restrict__ item_first,
                                                          int* __restrict__ n_items, int* __restrict__ item_bucket) {
  __shared__ int s_cells[1024], s_items[1024];
  const int t = threadIdx.x, per = (nb + 1023) / 1024;
  const int b0 = min(nb, t * per), b1 = min(nb, b0 + per);
  int cells = 0, items = 0;
  for (int b = b0; b < b1; ++b) cells += cells_of[b], items += (cells_of[b] + cap - 1) / cap;
  s_cells[t] = cells, s_items[t] = items;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {  // inclusive scans
    const int c = t >= off ? s_cells[t - off] : 0, i = t >= off ? s_items[t - off] : 0;
    __syncthreads();
    s_cells[t] += c, s_items[t] += i;
    __syncthreads();
  }
  cells = s_cells[t] - cells, items = s_items[t] - items;
  for (int b = b0; b < b1; ++b) {
    start[b] = cells, item_first[b] = items;
    const int k = (cells_of[b] + cap - 1) / cap;
    for (int q = 0; q < k; ++q) item_bucket[items + q] = b;
    cells += cells_of[b], items += k;
  }
  if (t == 1023) start[nb] = cells, item_first[nb] = items, *n_items = items;
}

// Writes each real cell into its key's part of the list (its bucket's
// start, then its sub-key's offset within the bucket).  Up to HIST_MAX
// keys a block reserves a run of each key's part for its cells with one
// atomic, then hands out the run's places in shared memory.
__global__ void __launch_bounds__(THREADS) bucket_fill_kernel(const int* __restrict__ a_idx,
                                                             const int* __restrict__ b_idx, int A, int B, int cells,
                                                             int nt, int sub, const int* __restrict__ start,
                                                             const int* __restrict__ sub_off, int* __restrict__ fill,
                                                             int* __restrict__ list) {
  __shared__ int hist[HIST_MAX];
  const int nk = nt * nt * sub;
  if (nk > HIST_MAX) {
    for (int c = blockIdx.x * THREADS + threadIdx.x; c < cells; c += gridDim.x * THREADS) {
      const int key = cell_key(a_idx, b_idx, A, B, c, nt, sub);
      if (key >= 0) list[start[key / sub] + sub_off[key] + atomicAdd(&fill[key], 1)] = c;
    }
    return;
  }
  for (int k = threadIdx.x; k < nk; k += THREADS) hist[k] = 0;
  __syncthreads();
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cells; c += gridDim.x * THREADS) {
    const int key = cell_key(a_idx, b_idx, A, B, c, nt, sub);
    if (key >= 0) atomicAdd(&hist[key], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nk; k += THREADS)  // the block's run of key k
    if (hist[k]) hist[k] = start[k / sub] + sub_off[k] + atomicAdd(&fill[k], hist[k]);
  __syncthreads();
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cells; c += gridDim.x * THREADS) {
    const int key = cell_key(a_idx, b_idx, A, B, c, nt, sub);
    if (key >= 0) list[atomicAdd(&hist[key], 1)] = c;
  }
}

// ---------------------------------------------------------------------------
// the bucketed path

struct Buckets {
  const int* list;         // the real cells, key by key (bucket by bucket)
  const int* start;        // (nb + 1,) first list entry of each bucket
  const int* item_first;   // (nb + 1,) first work item of each bucket
  const int* item_bucket;  // each work item's bucket
  const int* n_items;
  int nt;
};

// stage g (columns g KC ...) of work item `item` into ring slot `slot`
__device__ __forceinline__ void stage_copy(const float* __restrict__ x, int n, int d, bool vec, const Buckets& bk,
                                           int item, int g, float* slot) {
  const int b = bk.item_bucket[item];
  const int ta = b / bk.nt, tb = b % bk.nt;
  const int tiles = ta == tb ? 1 : 2;
  const int k0 = g * KC;
  if (vec) {  // 16-byte copies: d % 4 == 0, rows 16-byte aligned
    for (int e = threadIdx.x; e < tiles * T * (KC / 4); e += THREADS) {
      const int tile = e / (T * (KC / 4)), r = (e / (KC / 4)) % T, c4 = 4 * (e % (KC / 4));
      const int row = (tile ? tb : ta) * T + r;
      if (row >= n) continue;  // never read: no cell of the bucket has it
      const int k = k0 + c4;
      const int bytes = k < d ? 4 * min(4, d - k) : 0;
      const float* src = x + (size_t)row * d + (bytes ? k : 0);
      cp_async16_bytes(slot + tile * TILE_FLOATS + r * ROW + c4, src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < tiles * T * KC; e += THREADS) {
      const int tile = e / (T * KC), r = (e / KC) % T, c = e % KC;
      const int row = (tile ? tb : ta) * T + r;
      if (row >= n) continue;
      const int k = k0 + c;
      cp_async4(slot + tile * TILE_FLOATS + r * ROW + c, x + (size_t)row * d + (k < d ? k : 0), k < d);
    }
  }
}

template <int L, bool HALVE>
__global__ void __launch_bounds__(THREADS, 2) sbcn_bucket_kernel(const float* __restrict__ x, int n, int d,
                                                                 const int* __restrict__ a_idx,
                                                                 const int* __restrict__ b_idx, int A, int B,
                                                                 int panel, Buckets bk, float* __restrict__ out) {
  constexpr int C = cells_per_thread<L>();
  constexpr int CAP = C * THREADS;
  extern __shared__ __align__(16) unsigned long long ring_smem[];
  unsigned long long* full = ring_smem;
  unsigned long long* empty = ring_smem + STAGES;
  float* ring = reinterpret_cast<float*>(ring_smem + 2 * STAGES);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) ring_init(full + s, THREADS), ring_init(empty + s, THREADS);
  }
  __syncthreads();
  const int n_items = *bk.n_items;
  const int mine = blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;  // items of this block
  const int nst = (d + KC - 1) / KC, main = d - d % L;
  const bool vec = (d & 3) == 0 && ((size_t)x & 15) == 0;
  const long long total_stages = (long long)mine * nst;
  // the ring runs across this block's items: fill stage q = (item q / nst, stage q % nst)
  long long filled = 0;
  auto produce = [&](long long q) {
    const int slot = (int)(q % STAGES);
    ring_wait(empty + slot, (unsigned)((q / STAGES) & 1) ^ 1u);
    stage_copy(x, n, d, vec, bk, blockIdx.x + (int)(q / nst) * gridDim.x, (int)(q % nst), ring + slot * STAGE_FLOATS);
    ring_copies_arrive(full + slot);
  };
  for (; filled < total_stages && filled < STAGES - 1; ++filled) produce(filled);

  float acc[C][L], total[C], tail[C];
  int ra[C], rb[C], dst[C];
  long long q = 0;
  for (int it = 0; it < mine; ++it) {
    const int item = blockIdx.x + it * gridDim.x;
    const int b = bk.item_bucket[item];
    const int ta = b / bk.nt, tb = b % bk.nt;
    const int first = bk.start[b] + (item - bk.item_first[b]) * CAP, last = min(bk.start[b + 1], first + CAP);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = first + t + c * THREADS;
      dst[c] = -1, ra[c] = 0, rb[c] = 0;
      if (i < last) {
        const int cell = bk.list[i];
        const int p = cell / (A * B), r = cell % (A * B);
        dst[c] = cell;
        ra[c] = (a_idx[p * A + r / B] - ta * T) * ROW;
        rb[c] = (ta == tb ? 0 : TILE_FLOATS) + (b_idx[p * B + r % B] - tb * T) * ROW;
      }
      total[c] = -0.f, tail[c] = -0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) acc[c][l] = -0.f;
    }
    for (int g = 0; g < nst; ++g, ++q) {
      if (filled < total_stages) produce(filled++);
      const int slot = (int)(q % STAGES);
      ring_wait(full + slot, (unsigned)((q / STAGES) & 1));
      const float* base = ring + slot * STAGE_FLOATS;
      const int k0 = g * KC, kend = min(k0 + KC, main);
      for (int k = k0; k < kend;) {  // segments that end at a slice's end
        const int stop = min(kend, slice_end(k, panel, main));
        constexpr int SW = L > 4 ? L : 4;
        int kk = k - k0;
        for (; kk + SW <= stop - k0; kk += SW) {
#pragma unroll
          for (int h = 0; h < SW; h += 4) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float4 av = *reinterpret_cast<const float4*>(base + ra[c] + kk + h);
              const float4 bv = *reinterpret_cast<const float4*>(base + rb[c] + kk + h);
              acc[c][(h + 0) % L] = fmaf(av.x, bv.x, acc[c][(h + 0) % L]);
              acc[c][(h + 1) % L] = fmaf(av.y, bv.y, acc[c][(h + 1) % L]);
              acc[c][(h + 2) % L] = fmaf(av.z, bv.z, acc[c][(h + 2) % L]);
              acc[c][(h + 3) % L] = fmaf(av.w, bv.w, acc[c][(h + 3) % L]);
            }
          }
        }
        if constexpr (L <= 2) {  // a segment of 1 or 2 lanes may end off a multiple of 4
          for (; kk < stop - k0; ++kk) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float av = base[ra[c] + kk], bv = base[rb[c] + kk];
              if (L == 2 && (kk & 1)) {
                acc[c][L - 1] = fmaf(av, bv, acc[c][L - 1]);
              } else {
                acc[c][0] = fmaf(av, bv, acc[c][0]);
              }
            }
          }
        }
        k = stop;
        if (k == main || (panel > 0 && k % panel == 0)) {  // the slice ends: its lanes into the total
#pragma unroll
          for (int c = 0; c < C; ++c) {
            total[c] = __fadd_rn(total[c], reduce_lanes<L, HALVE>(acc[c]));
#pragma unroll
            for (int l = 0; l < L; ++l) acc[c][l] = -0.f;
          }
        }
      }
      for (int k = max(main, k0); k < min(d, k0 + KC); ++k) {  // the tail
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float av = base[ra[c] + k - k0], bv = base[rb[c] + k - k0];
          tail[c] = L == 8 ? fmaf(av, bv, tail[c]) : __fadd_rn(tail[c], __fmul_rn(av, bv));
        }
      }
      ring_arrive(empty + slot);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (dst[c] >= 0) out[dst[c]] = d > main ? __fadd_rn(total[c], tail[c]) : total[c];
    }
  }
}

// ---------------------------------------------------------------------------
// the dense path: one lane, a 64 x 64 block of a pair's cells a block

__global__ void __launch_bounds__(THREADS) sbcn_dense_kernel(const float* __restrict__ x, int d,
                                                            const int* __restrict__ a_idx,
                                                            const int* __restrict__ b_idx, int A, int B, int panel,
                                                            float* __restrict__ out) {
  __shared__ __align__(16) float sa[KC * DROW];
  __shared__ __align__(16) float sb[KC * DROW];
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int p = blockIdx.z, i0 = blockIdx.y * DT, j0 = blockIdx.x * DT;
  // this thread's staging: row t / 4 of each tile, columns 8 (t % 4) ... + 7 of a stage
  const int sr = t / 4, sc = 8 * (t % 4);
  const int ia = i0 + sr < A ? a_idx[(size_t)p * A + i0 + sr] : -1;
  const int ib = j0 + sr < B ? b_idx[(size_t)p * B + j0 + sr] : -1;
  float acc[4][4], total[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = -0.f, total[u][v] = -0.f;
  for (int k0 = 0; k0 < d; k0 += KC) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k = k0 + sc + c;
      sa[(sc + c) * DROW + sr] = ia >= 0 && k < d ? x[(size_t)ia * d + k] : 0.f;
      sb[(sc + c) * DROW + sr] = ib >= 0 && k < d ? x[(size_t)ib * d + k] : 0.f;
    }
    __syncthreads();
    const int kend = min(k0 + KC, d);
    for (int k = k0; k < kend;) {
      const int stop = min(kend, slice_end(k, panel, d));
      for (; k < stop; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(sa + (k - k0) * DROW + 4 * ty);
        const float4 b4 = *reinterpret_cast<const float4*>(sb + (k - k0) * DROW + 4 * tx);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      if (k == d || (panel > 0 && k % panel == 0)) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) total[u][v] = __fadd_rn(total[u][v], acc[u][v]), acc[u][v] = -0.f;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * ty + u;
    if (i >= A) continue;
    const bool a_real = a_idx[(size_t)p * A + i] >= 0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (j >= B) continue;
      out[((size_t)p * A + i) * B + j] = a_real && b_idx[(size_t)p * B + j] >= 0 ? total[u][v] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// a thread a cell, rows from global memory: XLA's loop, and the lanes past NT_MAX

// XLA's own loop over a [d] x [B, d] product (kernels/sbcn_tile.py::_loop_sum):
// 4 vectors of 8 lanes a step of 32 products; unrolled up to 17 steps (lane e
// one chain: the first vector's steps, then each later vector's in steps 1, 0,
// 2, 3, ...), looped past them (the four vectors' chains added in order); the
// 8 lane sums halved; the d % 32 products left through one vector stage, then
// one fmaf each.
__device__ float loop_dot(const float* __restrict__ a, const float* __restrict__ b, int d) {
  const int steps = d / 32, rest = d % 32;
  float s[8];
  for (int e = 0; e < 8; ++e) {
    if (steps <= 17) {
      float acc = -0.f;
      for (int t = 0; t < steps; ++t) acc = fmaf(a[32 * t + e], b[32 * t + e], acc);
      for (int u = 1; u < 4; ++u) {
        for (int i = 0; i < steps; ++i) {
          const int t = i < 2 && steps >= 2 ? 1 - i : i;
          const int k = 32 * t + 8 * u + e;
          acc = fmaf(a[k], b[k], acc);
        }
      }
      s[e] = acc;
    } else {
      float v[4];
      for (int u = 0; u < 4; ++u) {
        float acc = -0.f;
        for (int t = 0; t < steps; ++t) acc = fmaf(a[32 * t + 8 * u + e], b[32 * t + 8 * u + e], acc);
        v[u] = acc;
      }
      s[e] = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
    }
  }
  float total = __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[4]), __fadd_rn(s[2], s[6])),
                          __fadd_rn(__fadd_rn(s[1], s[5]), __fadd_rn(s[3], s[7])));
  int k0 = 32 * steps, width = 0, reps = 0;
  if (rest >= 8) {
    const int m = rest - rest % 4;
    width = m % 8 == 0 ? 8 : 4, reps = m / width;
  } else if (rest >= 2) {
    width = rest < 4 ? 2 : rest < 6 ? 4 : 2, reps = rest < 6 ? 1 : 3;
  }
  if (width) {
    float lane[8];
    for (int j = 0; j < width; ++j) {
      float acc = j == 0 ? total : -0.f;
      for (int i = 0; i < reps; ++i) acc = fmaf(a[k0 + width * i + j], b[k0 + width * i + j], acc);
      lane[j] = acc;
    }
    for (int h = width / 2; h >= 1; h /= 2)
      for (int j = 0; j < h; ++j) lane[j] = __fadd_rn(lane[j], lane[j + h]);
    total = lane[0];
    k0 += width * reps;
  }
  for (int k = k0; k < d; ++k) total = fmaf(a[k], b[k], total);
  return total;
}

template <int L, bool HALVE>
__device__ float lanes_dot(const float* __restrict__ a, const float* __restrict__ b, int d, int panel) {
  const int main = d - d % L;
  float acc[L], total = -0.f, tail = -0.f;
  for (int l = 0; l < L; ++l) acc[l] = -0.f;
  for (int k = 0; k < main;) {
    const int stop = slice_end(k, panel, main);
    for (; k < stop; k += L)
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = fmaf(a[k + l], b[k + l], acc[l]);
    total = __fadd_rn(total, reduce_lanes<L, HALVE>(acc));
    for (int l = 0; l < L; ++l) acc[l] = -0.f;
  }
  for (int k = main; k < d; ++k) tail = L == 8 ? fmaf(a[k], b[k], tail) : __fadd_rn(tail, __fmul_rn(a[k], b[k]));
  return d > main ? __fadd_rn(total, tail) : total;
}

template <int L, bool HALVE>
__global__ void __launch_bounds__(THREADS) sbcn_cell_kernel(const float* __restrict__ x, int d,
                                                           const int* __restrict__ a_idx,
                                                           const int* __restrict__ b_idx, int A, int B, int cells,
                                                           int panel, float* __restrict__ out) {
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < cells; c += gridDim.x * THREADS) {
    const int p = c / (A * B), r = c % (A * B);
    const int ia = a_idx[p * A + r / B], ib = b_idx[p * B + r % B];
    if (ia < 0 || ib < 0) {
      out[c] = 0.f;
      continue;
    }
    const float* ra = x + (size_t)ia * d;
    const float* rb = x + (size_t)ib * d;
    out[c] = L == 0 ? loop_dot(ra, rb, d) : lanes_dot<L ? L : 1, HALVE>(ra, rb, d, panel);
  }
}

// ---------------------------------------------------------------------------
// host side

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

int stride_grid(int cells) {
  const int blocks = (cells + THREADS - 1) / THREADS, cap = 8 * sm_count();
  return blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
}

template <int L, bool HALVE>
int bucket_occupancy(int* blocks_per_sm) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(sbcn_bucket_kernel<L, HALVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BUCKET_SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sbcn_bucket_kernel<L, HALVE>, THREADS, BUCKET_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *blocks_per_sm = per_sm;
  return 0;
}

// sub-keys a bucket: its tile's a-rows where the keys stay few
int sub_keys(int nb) { return (long long)nb * T <= SUB_KEYS_MAX ? T : 1; }

long long scratch_ints(int n, long long cells, int lanes) {
  const long long nt = (n + T - 1) / T, nb = nt * nt, nk = nb * sub_keys((int)nb);
  const int cap = THREADS * (lanes == 8 ? 4 : 8);
  return 3 * nk + nb + (nb + 1) + (nb + 1) + 1 + (cells / cap + (nb < cells ? nb : cells) + 1) + cells;
}

template <int L, bool HALVE>
int launch_bucketed(const float* x, int n, int d, const int* a_idx, const int* b_idx, int A, int B, int cells,
                    int panel, float* out, int* scratch, cudaStream_t s) {
  constexpr int CAP = cells_per_thread<L>() * THREADS;
  const int nt = (n + T - 1) / T, nb = nt * nt, sub = sub_keys(nb), nk = nb * sub;
  int* count = scratch;
  int* fill = count + nk;
  int* sub_off = fill + nk;
  int* bucket_cells = sub_off + nk;
  int* start = bucket_cells + nb;
  int* item_first = start + nb + 1;
  int* n_items = item_first + nb + 1;
  int* item_bucket = n_items + 1;
  const int max_items = cells / CAP + (nb < cells ? nb : cells) + 1;
  int* list = item_bucket + max_items;
  int per_sm = 0;
  int e = bucket_occupancy<L, HALVE>(&per_sm);
  if (e) return e;
  // counts and fills; with one key a bucket the offsets within it stay 0
  const size_t zeroed = (sub > 1 ? 2 : 3) * (size_t)nk;
  if ((e = (int)cudaMemsetAsync(count, 0, zeroed * sizeof(int), s))) return e;
  const int g = stride_grid(cells);
  bucket_count_kernel<<<g, THREADS, 0, s>>>(a_idx, b_idx, A, B, cells, nt, sub, count, out);
  if (sub > 1) bucket_sub_scan_kernel<<<nb < 8 * sm_count() ? nb : 8 * sm_count(), T, 0, s>>>(count, nb, sub_off,
                                                                                               bucket_cells);
  bucket_plan_kernel<<<1, 1024, 0, s>>>(sub > 1 ? bucket_cells : count, nb, CAP, start, item_first, n_items,
                                        item_bucket);
  bucket_fill_kernel<<<g, THREADS, 0, s>>>(a_idx, b_idx, A, B, cells, nt, sub, start, sub_off, fill, list);
  const Buckets bk{list, start, item_first, item_bucket, n_items, nt};
  const int grid = per_sm * sm_count() < max_items ? per_sm * sm_count() : max_items;
  sbcn_bucket_kernel<L, HALVE><<<grid, THREADS, BUCKET_SMEM, s>>>(x, n, d, a_idx, b_idx, A, B, panel, bk, out);
  return (int)cudaGetLastError();
}

template <int L, bool HALVE>
int launch_path(int path, const float* x, int n, int d, const int* a_idx, const int* b_idx, int P, int A, int B,
                int panel, float* out, int* scratch, cudaStream_t s) {
  const int cells = P * A * B;
  if (path == PATH_BUCKETED) {
    if ((n + T - 1) / T > NT_MAX) return (int)cudaErrorInvalidValue;
    return launch_bucketed<L, HALVE>(x, n, d, a_idx, b_idx, A, B, cells, panel, out, scratch, s);
  }
  if (path == PATH_DIRECT) {
    sbcn_cell_kernel<L, HALVE><<<stride_grid(cells), THREADS, 0, s>>>(x, d, a_idx, b_idx, A, B, cells, panel, out);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The ints of scratch the bucketed path needs for n points and P x A x B cells.
extern "C" long long repro_sbcn_tile_scratch_ints(int n, int P, int A, int B, int lanes) {
  return scratch_ints(n, (long long)P * A * B, lanes);
}

// The tiles a side of the bucket grid past which the bucketed path is refused.
extern "C" int repro_sbcn_tile_max_tiles() { return NT_MAX; }

// occ = {blocks per SM, threads, dynamic shared memory bytes, cells a thread}
// of the bucketed path's (lanes, halve) instance on this card.
extern "C" int repro_sbcn_tile_occupancy(int lanes, int halve, int* occ) {
  int e = (int)cudaErrorInvalidValue;
  if (lanes == 1 && !halve) e = bucket_occupancy<1, false>(occ);
  if (lanes == 2 && !halve) e = bucket_occupancy<2, false>(occ);
  if (lanes == 4) e = halve ? bucket_occupancy<4, true>(occ) : bucket_occupancy<4, false>(occ);
  if (lanes == 8) e = halve ? bucket_occupancy<8, true>(occ) : bucket_occupancy<8, false>(occ);
  occ[1] = THREADS, occ[2] = (int)BUCKET_SMEM, occ[3] = lanes == 8 ? 4 : 8;
  return e;
}

// x: (n, d) f32; a_idx (P, A), b_idx (P, B) i32 point ids, -1 padded;
// out: (P, A, B) f32 dot products in the order (lanes, halve, panel)
// described at the top (lanes 0: XLA's loop), 0 on padded cells, through
// `path` (0 loop, 1 dense, 2 bucketed, 3 direct); scratch holds
// repro_sbcn_tile_scratch_ints ints for the bucketed path.  Returns the
// cudaError_t of the launches, or cudaErrorInvalidValue for an order or a
// path it has no instance of.
extern "C" int repro_sbcn_tile_dots(const float* x, int n, int d, const int* a_idx, const int* b_idx, int P, int A,
                                    int B, int lanes, int halve, int panel, int path, float* out, int* scratch,
                                    void* stream) {
  if (P < 1 || A < 1 || B < 1 || d < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if ((long long)P * A * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (panel < 0 || (lanes > 0 && panel % lanes)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int cells = P * A * B;
  if (lanes == 0) {
    if (path != PATH_LOOP || halve || panel) return (int)cudaErrorInvalidValue;
    sbcn_cell_kernel<0, false><<<stride_grid(cells), THREADS, 0, s>>>(x, d, a_idx, b_idx, A, B, cells, 0, out);
    return (int)cudaGetLastError();
  }
  if (path == PATH_DENSE) {
    if (lanes != 1 || halve) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + DT - 1) / DT, (A + DT - 1) / DT, P);
    if (grid.z > 65535) return (int)cudaErrorInvalidValue;
    sbcn_dense_kernel<<<grid, THREADS, 0, s>>>(x, d, a_idx, b_idx, A, B, panel, out);
    return (int)cudaGetLastError();
  }
  if (lanes == 1 && !halve) return launch_path<1, false>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s);
  if (lanes == 2 && !halve) return launch_path<2, false>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s);
  if (lanes == 4) {
    return halve ? launch_path<4, true>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s)
                 : launch_path<4, false>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s);
  }
  if (lanes == 8) {
    return halve ? launch_path<8, true>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s)
                 : launch_path<8, false>(path, x, n, d, a_idx, b_idx, P, A, B, panel, out, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}
