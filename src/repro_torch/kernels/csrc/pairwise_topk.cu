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
// What bounds it on the H100: operations.  d2 is symmetric, so the function
// needs n (n - 1) / 2 (2d + 3) float32 operations (n = 16000, d = 8: 2.4e9)
// on the FMA pipes, 67 TFLOP/s at most; the warp-per-row design below sweeps
// all n^2 pairs.  The bytes are n * d * 4 in and n * K * 8 out, negligible
// beside that.  The top-K adds one compare per (row, key) and, per accepted
// key, a merge step; after the list fills, a key is accepted with
// probability about K / (keys seen), so a row accepts about K ln(n / K) keys
// of its n.
//
// Design: a warp owns R query rows (R = 4 for d <= 8, 2 for d = 16, else 1),
// held in registers for the fixed widths d in {2, 4, 8, 16, 32} (a template
// per width, so the dot products unroll) and in shared memory otherwise
// (d <= 256).  The block's 8 warps share each key tile: one thread stages one
// key row and its norm into shared memory, transposed in float4 (float2 at
// d = 2) chunks, (d / 4, tile, 4), so lane l reads key l of a 32-key round
// with 16-byte loads and no bank conflicts.  Each lane computes d2 for its
// key against the warp's R rows (independent FMA chains) and compares it with
// the d2 of each row's K-th entry, a warp-uniform register; only the rounds
// at the end of the keys, over the warp's own rows (self) or in the last
// block run the masks, the others a copy without them.  A ballot collects a
// round's candidates and the warp merges them one at a time into the row's
// sorted list, then reads the new K-th entry once: a key that an earlier
// merge of the round pushed past the threshold, or a tie on d2 that loses on
// the index, only moves entries beyond K.  An entry is one 64-bit key, d2's
// float bits above the index, whose unsigned order is the strict (d2, idx)
// order, so the result does not depend on the order in which keys merge.
// The list is spread over the lanes: entry p sits in lane p / S, slot p % S,
// with S <= 8 slots, so K <= 256 (KMAX; longer lists take the select
// instances, below); a merge moves entry p - 1 to p where the
// new key orders before it, register moves within a lane and one shuffle-up
// between lanes, whatever S.  Past S = 4 a warp owns one row (R = 1), so the
// list's 64-bit slots stay in registers.  K up to 256 is one sweep over the
// distances with a longer list, not passes over them: the list's order does
// not depend on its length, and a second pass would compute every d2 again.
// Up to d = 256 a warp owns its rows: no atomics, no second pass.
//
// Above d = 256 (the sliced instance) the sweep is a float32 matrix
// product, n (n - 1) / 2 2d operations over the upper triangle (n = 4000,
// d = 1536: 2.5e10, 0.37 ms at 67 TFLOP/s), and what bounds a warp-per-row
// design is the load/store unit, not the FMA pipes: one shared-memory load
// per FMA (32 floats a clock an SM against 128 FMAs), on key rows staged one
// float at a time by one thread each.  So the sliced instance is a
// register-blocked product with the top-K in its epilogue.  A block of
// 256 threads takes BM = 128 query rows x BN = 128 keys, each thread an
// 8 x 8 tile of accumulators fed by float2 loads (one 8-byte load for 8
// FMAs); at 254 registers a thread, one block an SM.  d
// streams through shared memory in slices of BK = 32 floats, k contiguous,
// copied with 16-byte cp.async (4-byte copies where d % 4 != 0) into two
// buffers, so the next slice lands while this one is used; rows past n and
// floats past d are zero-filled but never summed.  Once a key tile has its
// full d, the block writes its d2 tile to shared memory, a warp takes 16
// rows, compares each d2 with the row's K-th d2 (a shared-memory
// threshold) and merges the few survivors into the row's list as above,
// kept in global scratch as partial lists that a second short pass merges
// with the same 64-bit keys, whose strict order makes the result
// independent of how the keys were split and of the merge order.  d2 is
// symmetric bit for bit (fmaf's product, the norms' sum and the panel sums
// all commute), so where a partial list per (row, key tile) fits 64 MiB
// (n = 4000 at K <= 64) the blocks take only the upper triangle of tiles,
// and a tile's columns feed the lists of its keys' rows as its rows feed
// its own: half the products (n = 4000: 528 tiles, four waves of 132).
// Past that budget the keys are split across blocks instead, so that the
// 32 row tiles of n = 4000 fill the card.  |x|^2 comes from a pre-pass
// (norms_win32.cuh: rows staged a block at a time), once a call.
//
// K > 256 (the select instances).  A list longer than 256 cannot stay in a
// warp's registers (the sliced instance already takes 254 a thread), so
// these instances select instead of merging as they stream.  Both order the
// row's strict 64-bit keys (d2's bits above the index, as the lists').
//
// The streamed select (256 < K <= KSTREAM = 1024 at d <= 256) keeps the
// distances out of device memory: at d = 8 a pair costs 2d + 3 operations,
// fewer than the 8 bytes of writing and reading it back (the stored select
// moved 1.02 GB at n = 16000).  One sweep over the key tiles with the list
// instances' staging and arithmetic (load_rows / stage_key / row_d2, so the
// bits are the lists' bits); a warp owns two rows at d < 32 (one staged key
// serves both), else one, and each row a buffer of candidate keys in shared
// memory and a threshold tau (+inf at first).  A round's keys at most tau
// go into the buffer at a warp-aggregated offset (a ballot and a popcount: no
// atomics, no match); where the round would overflow the buffer, the warp
// compacts it: a radix select (8-bit digits from the highest bit in which
// the buffer's keys differ, a shared-memory histogram a warp) finds a key
// tau with K keys at or below it (and at most an eighth of the free room
// more: the last pass may stop early), and the keys above tau go.  tau is
// the K-th smallest key of a subset of the row's keys, so it is never below
// the row's true K-th key, and a key dropped is strictly above it: the
// result is the K smallest keys whatever the order of arrival.  After the
// sweep the K smallest are selected exactly, the smallest P2 (the largest
// power of two at most K) sorted by a bitonic sort, and the rest apart (one
// warp minimum a key up to 16 of them, K = 263: 256 + 7; else a second
// select and sort).  After the first fill a key enters with probability
// about K / (keys seen), so a row takes some K ln(n / slots) keys past its
// first buffer and compacts a few times (n = 16000, K = 263: five).  What
// bounds it on this card is not the card's rates but the warps' latency:
// the buffers (576 keys a row at K = 263, 72 KiB of a block's 112 KiB) hold
// an SM to 16 warps, so the compactions' and the sorts' dependent shared-
// memory passes show; the sweep itself is the list instances' arithmetic
// plus two ballots and an append a round.  KSTREAM is where the buffers
// (K + K / 2 keys a row at least) still fit two blocks an SM with at least
// two rows a block: K = 1024 takes 2304-key buffers, two warps a block.
// The workspace holds the norms above d = 32, nothing else.
//
// The stored select (K > KSTREAM up to n - 1, and every K > 256 above
// d = 256, where a recompute would repeat the product) stores the distances
// and selects from them.  Per chunk of rows (as many as 256 MiB of d2 rows
// hold, in tiles of 128; set with repro_pairwise_topk_set_select_plan):
//   1. the distance pass writes the chunk's d2 rows (self +inf) into the
//      workspace with the list instances' own staging and arithmetic:
//      load_rows / stage_key / row_d2 at d <= 256 (rows in registers at
//      d in {2, 4, 8, 16, 32}, in shared memory otherwise; the key tiles
//      split across blocks so that a chunk fills the card), and the
//      register-blocked product sliced_d2_tile above 256, so the bits are
//      the K <= 256 lists' bits.  At d = 1536 the select reads a row four
//      to seven times (one pass a digit, one to gather), which recomputed
//      would mean 0.37 ms of FMA a sweep (n = 4000) against 0.019 ms to
//      write and read the 64 MB once.
//   2. the select kernel, a block a row: a radix select over the row's
//      strict 64-bit keys, digit by digit from the top (d2 as 11 + 11 + 10
//      bits, then the index as 11 + 10 + 11), each digit a shared-memory
//      histogram of the keys that share the digits so far (warp-aggregated
//      atomics), stopping where the chosen bin holds exactly the keys still
//      wanted.  It yields the largest key T with exactly K keys at most T, so
//      exact duplicates (one bin holding every key) resolve on the index,
//      lowest first, whatever order the atomics run in.  The keys at most T
//      are gathered into shared memory (any order), sorted by a bitonic sort
//      and written as (d2, idx).  Past 16384 keys (128 KiB) the row takes
//      its ranks a sort tile at a time: the threshold of rank 16384 t, the
//      keys between two thresholds gathered and sorted, up to K = n - 1.
// Among strict keys the first 256 entries of a K = 257 list are the
// K = 256 list: both are the smallest keys in the same strict order.
//
// Arithmetic per pair, in the reference's order: d2 = fmaxf((qn + kn) -
// 2 dot, 0), with the norms and the dot product summed as XLA on the CPU
// sums the reference's top-K (its Pallas kernel in interpret mode, and its
// jnp twin): |x|^2 as an fmaf chain in index order at d = 2-4 and 9-32,
// unfused in index order at d = 5-8, and in XLA's windows of 32
// (norms_win32.cuh) above 32 (kernels/ops.py::sum_order, program "topk");
// q.k as one fmaf chain in index order per PANEL = 512 floats of d, each
// chain starting from its first product, and the panel sums added in order
// (kernels/pairwise_topk.py::PANEL says where 512 comes from).  Products
// are plain float32 FFMA: no tensor cores, hence no TF32, which cannot give
// those bits (and at d = 8 a depth-8 product gains nothing from wgmma).

#include <cuda_runtime.h>
#include <cfloat>
#include <type_traits>
#include <math_constants.h>

#include "cp_async.cuh"
#include "norms_win32.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KMAX = 256;                // 8 slots of 32 lanes; longer lists take the select instance
constexpr int MAX_D_TILED = 256;         // above this width the sliced instance runs
constexpr int KEY_TILE = 1024;           // keys staged per tile at most
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, dynamic smem needs an opt-in
constexpr int SMEM_BUDGET = 96 * 1024;   // two blocks per SM
// the sliced instance: BM rows x BN keys a block, TM x TN a thread, BK floats
// of d a slice (BKP with the padding that keeps float2 loads conflict-free)
constexpr int BM = 128, BN = 128, BK = 32, BKP = BK + 4, TM = 8, TN = 8;
constexpr int STAGES = 2;                // slices in flight
constexpr int PANEL = 512;               // one fmaf chain per PANEL floats of d; BK divides it
constexpr int SD2 = BN + 1;              // row stride of the d2 tile: rows and columns read conflict-free
constexpr int STAGE_FLOATS = STAGES * (BM + BN) * BKP;
constexpr int UNION_FLOATS = TM * TN * THREADS > BM * SD2 ? TM * TN * THREADS : BM * SD2;
constexpr size_t SLICED_SMEM = (size_t)(STAGE_FLOATS + UNION_FLOATS + BM) * sizeof(float);
static_assert(PANEL % BK == 0, "a panel ends on a slice boundary");
// the select instance: the bins of a digit; the keys a block sorts in
// shared memory at once (16384: 128 KiB) and the bytes of one chunk of d2
// rows in the workspace (256 MiB), both settable for tests
// (repro_pairwise_topk_set_select_plan)
constexpr int SEL_BINS = 2048;
int sort_max = 16384;
size_t select_budget = (size_t)256 << 20;
static_assert(SEL_BINS % THREADS == 0 && (SEL_BINS / 2) % THREADS == 0, "a thread scans whole bins");
// the partial lists' bytes the mirrored plan may take (64 MiB; 0 splits the
// keys at every shape: repro_pairwise_topk_set_mirror_budget)
size_t mirror_budget = (size_t)64 << 20;
// the streamed select: the longest list it takes (K <= KSTREAM at d <= 256),
// a block's shared memory (two blocks an SM), the part of it the rows'
// candidate buffers may take and the least key tile left beside them; the
// bins of a compaction's digit.  For tests
// (repro_pairwise_topk_set_stream_plan): the buffer fill that triggers a
// compaction (0: the whole buffer) and the K above which the instance runs.
constexpr int KSTREAM = 1024;
constexpr int STREAM_SMEM = 112 * 1024;
constexpr int STREAM_BUF_BUDGET = 72 * 1024, STREAM_MIN_TILE = 64;
constexpr int DIGIT_BITS = 8, DIGIT_BINS = 1 << DIGIT_BITS;
static_assert(DIGIT_BINS == 32 * 8, "a lane scans 8 bins");
int stream_cap = 0;
int stream_from = KMAX;

// the reference's order for |x|^2 at width D: unfused at d = 5-8, fmaf
// chains at the other widths a template instance takes (d > 32 reads a
// pre-pass's windows of 32)
__host__ __device__ constexpr bool seq_norm(int d) { return d >= 5 && d <= 8; }

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <int D>
__host__ __device__ constexpr int vec_width() { return D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1); }

template <int D, int S>
__host__ __device__ constexpr int rows_per_warp() {
  return S > 4 || D == 0 || D >= 32 ? 1 : (D >= 16 ? 2 : 4);
}

// |v|^2 of D values in registers, in the reference's order at width D
template <int D>
__device__ __forceinline__ float norm_of(const float (&v)[D]) {
  if constexpr (seq_norm(D)) {
    float s = __fmul_rn(v[0], v[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
    return s;
  } else {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) s = fmaf(v[j], v[j], s);
    return s;
  }
}

// Merge key c into the warp's sorted list (entry p in lane p / S, slot
// p % S).  A key is d2's float bits above the index (d2 is +0 or more and
// finite, so its bits order as an unsigned integer); ~0 is the empty entry.  Entry p keeps its key where that orders before c, takes c where
// entry p - 1 does (or p = 0), else takes entry p - 1: within a lane a move
// between registers, across lanes one shuffle-up of the last slot.  A key
// that orders after entry K - 1 only moves entries past K, or none.
template <int S>
__device__ __forceinline__ void merge(unsigned long long (&e)[S], unsigned long long c, int lane) {
  unsigned long long prev = __shfl_up_sync(FULL, e[S - 1], 1);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned long long cur = e[s];
    if (!(cur < c)) e[s] = prev < c || (s == 0 && lane == 0) ? c : prev;
    prev = cur;
  }
}

// the warp's 32 keys in ascending order over the lanes (a bitonic sort)
__device__ __forceinline__ void bitonic_sort(unsigned long long& c, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, c, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & size) == 0);
      c = keep_min ? (o < c ? o : c) : (o < c ? c : o);
    }
}

// entry K - 1 of the warp's list (lane klane, slot kslot), on every lane
template <int S>
__device__ __forceinline__ unsigned long long kth(const unsigned long long (&e)[S], int klane, int kslot) {
  unsigned long long v = e[0];
#pragma unroll
  for (int s = 1; s < S; ++s) v = s == kslot ? e[s] : v;
  return __shfl_sync(FULL, v, klane);
}

__device__ __forceinline__ float key_d2(unsigned long long v) {
  return v == ~0ull ? FLT_MAX : __uint_as_float((unsigned)(v >> 32));
}

// Stage key row `r` of the tile: coordinates into shared memory, transposed
// in chunks of V floats, and |k|^2 in the reference's order (`pre`, the
// pre-pass's value, where d > 32).
template <int D>
__device__ __forceinline__ void stage_key(const float* __restrict__ src, int r, int kt, int d,
                                          const float* pre, float* sk, float* skn) {
  if constexpr (D > 0) {
    constexpr int V = vec_width<D>();
    float v[D];
#pragma unroll
    for (int c = 0; c < D / V; ++c) {
      if constexpr (V == 4) {
        const float4 t = reinterpret_cast<const float4*>(src)[c];
        v[4 * c] = t.x, v[4 * c + 1] = t.y, v[4 * c + 2] = t.z, v[4 * c + 3] = t.w;
        reinterpret_cast<float4*>(sk)[c * kt + r] = t;
      } else {
        const float2 t = reinterpret_cast<const float2*>(src)[c];
        v[2 * c] = t.x, v[2 * c + 1] = t.y;
        reinterpret_cast<float2*>(sk)[c * kt + r] = t;
      }
    }
    skn[r] = norm_of<D>(v);
  } else if (pre != nullptr) {
    for (int j = 0; j < d; ++j) sk[j * kt + r] = src[j];
    skn[r] = *pre;
  } else {
    const bool seq = seq_norm(d);
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float v = src[j];
      sk[j * kt + r] = v;
      s = seq ? (j == 0 ? __fmul_rn(v, v) : __fadd_rn(s, __fmul_rn(v, v))) : fmaf(v, v, s);
    }
    skn[r] = s;
  }
}

// The warp's R query rows from row0 (a row at or past n_rows is dead and
// reads zeros): coordinates in registers where D > 0, else in the warp's
// shared row qs (generic d, R = 1), and |q|^2 in the reference's order
// (`norms`, the pre-pass's values, where d > 32).
template <int D, int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, const float* __restrict__ norms, int n_rows,
                                          int d, int row0, int lane, float* qs, float (&q)[R][D > 0 ? D : 1],
                                          float (&qn)[R], int (&row)[R], bool (&live)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = row0 + r;
    live[r] = row[r] < n_rows;
    qn[r] = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) q[r][j] = live[r] ? x[(size_t)row[r] * D + j] : 0.f;
      qn[r] = norm_of<D>(q[r]);
    }
  }
  if constexpr (D == 0) {
    for (int j = lane; j < d; j += 32) qs[j] = live[0] ? x[(size_t)row[0] * d + j] : 0.f;
    __syncwarp();
    if (norms != nullptr) {
      qn[0] = live[0] ? norms[row[0]] : 0.f;
    } else if (seq_norm(d)) {
      qn[0] = __fmul_rn(qs[0], qs[0]);
      for (int j = 1; j < d; ++j) qn[0] = __fadd_rn(qn[0], __fmul_rn(qs[j], qs[j]));
    } else {
      for (int j = 0; j < d; ++j) qn[0] = fmaf(qs[j], qs[j], qn[0]);
    }
  }
}

// d2 of key kr of the staged tile (sk, skn: stage_key's layout, kt keys)
// against the warp's R rows: an fmaf chain in index order a row (d <= 256
// is one panel), then max((|q|^2 + |k|^2) - 2 q.k, 0).
template <int D, int R>
__device__ __forceinline__ void row_d2(const float (&q)[R][D > 0 ? D : 1], const float (&qn)[R], const float* qs,
                                       const float* sk, const float* skn, int kt, int kr, int d, float (&d2)[R]) {
  constexpr int V = vec_width<D>();
  float kc[D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int c = 0; c < D / V; ++c) {
      if constexpr (V == 4) {
        const float4 t = reinterpret_cast<const float4*>(sk)[c * kt + kr];
        kc[4 * c] = t.x, kc[4 * c + 1] = t.y, kc[4 * c + 2] = t.z, kc[4 * c + 3] = t.w;
      } else {
        const float2 t = reinterpret_cast<const float2*>(sk)[c * kt + kr];
        kc[2 * c] = t.x, kc[2 * c + 1] = t.y;
      }
    }
  }
  const float kn = skn[kr];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dot = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) dot = fmaf(q[r][j], kc[j], dot);
    } else {
      for (int j = 0; j < d; ++j) dot = fmaf(qs[j], sk[j * kt + kr], dot);
    }
    d2[r] = fmaxf(qn[r] + kn - 2.f * dot, 0.f);
  }
}

// d <= 256.  `norms` holds |x|^2 from the pre-pass where d > 32, else null.
template <int D, int S>
__global__ void __launch_bounds__(THREADS, 2) pairwise_topk_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d_rt, int k, int kt,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int R = rows_per_warp<D, S>();
  constexpr int DR = D > 0 ? D : 1;  // register extent of a row
  const int d = D > 0 ? D : d_rt;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;           // (d / V, kt, V): key tile
  float* skn = sk + kt * d;   // (kt,): key norms
  float* sq = skn + kt;       // (WARPS, d): the warp's query row (generic d only)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (blockIdx.x * WARPS + warp) * R;

  float q[R][DR];
  float qn[R];
  int row[R];
  bool live[R];
  load_rows<D, R>(x, norms, n, d, row0, lane, sq + warp * d, q, qn, row, live);

  // the rows' lists, and the d2 of each row's K-th entry (FLT_MAX while
  // the list has room: a key with d2 = +inf never enters)
  unsigned long long e[R][S];
  float wd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < S; ++s) e[r][s] = ~0ull;
    wd[r] = FLT_MAX;
  }
  const int klane = (k - 1) / S, kslot = (k - 1) % S;

  for (int k0 = 0; k0 < n; k0 += kt) {
    const int rows = min(kt, n - k0);
    __syncthreads();  // the previous key tile is consumed
    for (int r = tid; r < rows; r += THREADS)
      stage_key<D>(x + (size_t)(k0 + r) * d, r, kt, d, norms != nullptr ? norms + k0 + r : nullptr, sk, skn);
    __syncthreads();
    // One 32-key round: lane l takes key b + l against the warp's R rows.
    // Only a round at the end of the keys, over the warp's own rows or in
    // the last block needs the masks; the others run a copy without them.
    auto sweep_round = [&](const int b, auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
      const int kr = b + lane;  // < kt: kt is a multiple of 32
      const int c0 = k0 + b;
      // the R rows' distances first (independent FMA chains), then their
      // candidates: keys whose d2 is at most the row's K-th d2.  A tie on
      // d2 that loses on the index is merged too and only moves entries
      // past K.
      float d2[R];
      row_d2<D, R>(q, qn, sq + warp * d, sk, skn, kt, kr, d, d2);
      bool cand[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cand[r] = d2[r] <= wd[r];
        if constexpr (MASKED) cand[r] = cand[r] && live[r] && kr < rows && c0 + lane != row[r];
        any |= cand[r];
      }
      if (!__any_sync(FULL, any)) return;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        unsigned m = __ballot_sync(FULL, cand[r]);
        if (m == 0u) continue;
        // merge every candidate of the round, then move the threshold: one
        // that a merge in this round would have rejected only moves
        // entries past K.  A candidate's key is (its d2's bits, its column).
        do {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const unsigned hi = __shfl_sync(FULL, __float_as_uint(d2[r]), src);
          merge<S>(e[r], (unsigned long long)hi << 32 | (unsigned)(c0 + src), lane);
        } while (m != 0u);
        wd[r] = key_d2(kth<S>(e[r], klane, kslot));
      }
    };
    for (int b = 0; b < rows; b += 32) {
      const int c0 = k0 + b;
      // a vote, so that the compiler sees a warp-uniform branch
      if (__all_sync(FULL, b + 32 <= rows && row0 + R <= n && (row0 + R <= c0 || row0 >= c0 + 32)))
        sweep_round(b, std::false_type{});
      else
        sweep_round(b, std::true_type{});
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live[r]) continue;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = lane * S + s;
      if (p < k) {
        const unsigned long long v = e[r][s];
        out_d[(size_t)row[r] * k + p] = v == ~0ull ? CUDART_INF_F : __uint_as_float((unsigned)(v >> 32));
        out_i[(size_t)row[r] * k + p] = v == ~0ull ? -1 : (int)(unsigned)v;
      }
    }
  }
}

// The sliced instance's d2 tile: rows [m0, m0 + BM) against keys [k0,
// k0 + BN) into uni (BM, SD2), self pairs and rows or keys past n +inf (an
// entry that never enters a list).  A register-blocked product: d streams
// through `stage` in slices of BK floats (two buffers of cp.async copies),
// each thread keeps TM x TN fmaf chains, one a panel of PANEL floats, and
// the panel sums are added in order through uni.  Ends at the block's
// barrier, the tile written.
__device__ __forceinline__ void sliced_d2_tile(const float* __restrict__ x, const float* __restrict__ norms, int n,
                                               int d, int m0, int k0, float* stage, float* uni) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7, wm = warp >> 1, wn = warp & 1;
  const int n_slices = (d + BK - 1) / BK;
  const bool vec = (d & 3) == 0;  // rows start on 16 bytes: 16-byte copies

  // stage the slice [s0, s0 + BK) of the block's rows and of keys k0.. into
  // buffer b; past the last slice only an empty group, so that every
  // iteration waits for the same count
  auto issue = [&](int b, int s0) {
    float* dst = stage + b * (BM + BN) * BKP;
    if (s0 < d && vec) {
      for (int c = tid; c < (BM + BN) * (BK / 4); c += THREADS) {
        const int r = c / (BK / 4), col = s0 + c % (BK / 4) * 4;
        const int g = r < BM ? m0 + r : k0 + r - BM;
        const bool ok = g < n && col < d;
        cp_async16(dst + r * BKP + c % (BK / 4) * 4, ok ? x + (size_t)g * d + col : x, ok);
      }
    } else if (s0 < d) {
      for (int c = tid; c < (BM + BN) * BK; c += THREADS) {
        const int r = c / BK, col = s0 + c % BK;
        const int g = r < BM ? m0 + r : k0 + r - BM;
        const bool ok = g < n && col < d;
        cp_async4(dst + r * BKP + c % BK, ok ? x + (size_t)g * d + col : x, ok);
      }
    }
    cp_async_commit();
  };

  // acc[i][j]: row wm 32 + ty + 4 i against key wn 64 + tx + 8 j
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = -0.f;  // fmaf(a, b, -0) is a b rounded: the first product
  bool folded = false;
#pragma unroll
  for (int b = 0; b < STAGES - 1; ++b) issue(b, b * BK);
  for (int s = 0; s < n_slices; ++s) {
    issue((s + STAGES - 1) % STAGES, (s + STAGES - 1) * BK);
    cp_async_wait<STAGES - 1>();  // slice s has landed
    __syncthreads();
    const float* sq = stage + s % STAGES * (BM + BN) * BKP + (wm * 32 + ty) * BKP;
    const float* sk = stage + s % STAGES * (BM + BN) * BKP + (BM + wn * 64 + tx) * BKP;
    const int ds = min(BK, d - s * BK);
    if (ds == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 2) {
        float2 a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float2*>(sq + 4 * i * BKP + kk);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float2*>(sk + 8 * j * BKP + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      }
    } else {  // the last slice of a ragged d: only the floats below d
      for (int kk = 0; kk < ds; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sq[4 * i * BKP + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sk[8 * j * BKP + kk];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // a panel ends here: add its chains to the totals, in order, and
    // start the next panel's chains from their first products
    const int done = (s + 1) * BK;
    if (done % PANEL == 0 && done < d) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float& tot = uni[(i * TN + j) * THREADS + tid];
          tot = folded ? __fadd_rn(tot, acc[i][j]) : acc[i][j];
          acc[i][j] = -0.f;
        }
      folded = true;
    }
    __syncthreads();  // buffer s % STAGES is free for slice s + STAGES
  }
  if (folded) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(uni[(i * TN + j) * THREADS + tid], acc[i][j]);
    __syncthreads();  // every total is read before the d2 tile overwrites them
  }
  // the d2 tile
  float kn[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int g = k0 + wn * 64 + tx + 8 * j;
    kn[j] = g < n ? norms[g] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = wm * 32 + ty + 4 * i, g = m0 + r;
    const float qn = g < n ? norms[g] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = wn * 64 + tx + 8 * j;
      const float v = fmaxf(__fsub_rn(__fadd_rn(qn, kn[j]), 2.f * acc[i][j]), 0.f);
      uni[r * SD2 + c] = g < n && k0 + c < n && k0 + c != g ? v : CUDART_INF_F;
    }
  }
  __syncthreads();
}

// The sliced instance (d > 256; see the note at the top).  Each row keeps
// `slots` partial lists of `kp` entries, sorted, at lists[(row * slots +
// slot) * kp ...]; the merge kernel below finishes.  With the keys split,
// block (bx, by) takes rows [BM bx, BM bx + BM) against key tiles [tps by,
// tps by + tps), into slot by.  Mirrored (d2 is symmetric bit for bit:
// fmaf's product, the norms' sum and the panels' sums all commute), block
// b takes the b-th tile (R, T), R <= T, of the upper triangle and merges
// its rows' survivors into slot T of rows R and its columns' into slot R
// of rows T.
template <int S>
__global__ void __launch_bounds__(THREADS, 1) pairwise_topk_sliced_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d, int k, int tps,
    bool mirror, int slots, int kp, unsigned long long* __restrict__ lists) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                   // STAGES x (BM query rows, BN key rows) x BKP: the slices
  float* uni = stage + STAGE_FLOATS;     // the panel totals (TM TN, THREADS), then the d2 tile (BM, SD2)
  float* thr = uni + UNION_FLOATS;       // (BM,): the d2 of each row's K-th entry
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key_tiles = (n + BN - 1) / BN;
  int rt = blockIdx.x, t_begin = blockIdx.y * tps, t_end = min(key_tiles, t_begin + tps);
  if (mirror) {
    int rem = blockIdx.x;
    for (rt = 0; rem >= key_tiles - rt; ++rt) rem -= key_tiles - rt;
    t_begin = rt + rem, t_end = t_begin + 1;
  }
  const int m0 = rt * BM;
  const int klane = (k - 1) / S, kslot = (k - 1) % S;
  for (int r = tid; r < BM; r += THREADS) thr[r] = FLT_MAX;

  // merge the survivors of line g (a row of the d2 tile, or in the mirror a
  // column), whose key key0 + 32 i + lane has d2 v[i], into its partial
  // list `slot` (a fresh one when `fresh`); wd is the line's K-th d2 so far
  auto merge_line = [&](int g, const float (&v)[BN / 32], int key0, int slot, bool fresh, float wd) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) any |= v[i] <= wd;
    if (!__any_sync(FULL, any) && !fresh) return wd;
    unsigned long long* lst = lists + ((size_t)g * slots + slot) * kp;
    unsigned long long e[S];
#pragma unroll
    for (int s = 0; s < S; ++s) e[s] = fresh || lane * S + s >= kp ? ~0ull : lst[lane * S + s];
    int i0 = 0;
    if constexpr (S == 1) {
      // a fresh list of one slot a lane takes the first 32 keys whole:
      // sorted at once (a bitonic sort over the lanes), the list that
      // merging them one by one would leave
      if (fresh) {
        e[0] = v[0] <= wd ? (unsigned long long)__float_as_uint(v[0]) << 32 | (unsigned)(key0 + lane) : ~0ull;
        bitonic_sort(e[0], lane);
        wd = key_d2(kth<S>(e, klane, kslot));
        i0 = 1;
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      if (i < i0) continue;
      unsigned m = __ballot_sync(FULL, v[i] <= wd);
      if (m == 0u) continue;
      do {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const unsigned hi = __shfl_sync(FULL, __float_as_uint(v[i]), src);
        merge<S>(e, (unsigned long long)hi << 32 | (unsigned)(key0 + i * 32 + src), lane);
      } while (m != 0u);
      wd = key_d2(kth<S>(e, klane, kslot));
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (lane * S + s < kp) lst[lane * S + s] = e[s];
    return wd;
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    sliced_d2_tile(x, norms, n, d, m0, k0, stage, uni);
    // warp w merges the survivors of its BM / WARPS rows; the first tile
    // of a list starts it (and writes it even without a survivor)
    const bool first = t == t_begin;
    for (int rr = 0; rr < BM / WARPS; ++rr) {
      const int r = warp * (BM / WARPS) + rr, g = m0 + r;
      if (g >= n) break;  // warp-uniform
      float v[BN / 32];
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) v[i] = uni[r * SD2 + i * 32 + lane];
      const float wd = merge_line(g, v, k0, mirror ? t : blockIdx.y, first, thr[r]);
      if (lane == 0) thr[r] = wd;
    }
    // mirrored, off the diagonal: the columns, as rows of tile t against
    // the keys of tile rt
    if (mirror && t != rt) {
      for (int cc = 0; cc < BN / WARPS; ++cc) {
        const int c = warp * (BN / WARPS) + cc, g = k0 + c;
        if (g >= n) break;  // warp-uniform
        float v[BM / 32];
#pragma unroll
        for (int i = 0; i < BM / 32; ++i) v[i] = uni[(i * 32 + lane) * SD2 + c];
        merge_line(g, v, m0, rt, true, FLT_MAX);
      }
    }
    __syncthreads();  // the d2 tile is consumed
  }
}

// The sliced instance's second pass: a warp merges a row's `slots` partial
// lists (their first min(k, kp) entries each, sorted) into its list of k.
template <int S>
__global__ void __launch_bounds__(THREADS) pairwise_topk_merge_kernel(
    const unsigned long long* __restrict__ lists, int n, int k, int slots, int kp,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform
  const int klane = (k - 1) / S, kslot = (k - 1) % S;
  unsigned long long e[S];
#pragma unroll
  for (int s = 0; s < S; ++s) e[s] = ~0ull;
  const int len = min(k, kp);
  for (int sp = 0; sp < slots; ++sp) {
    const unsigned long long* lst = lists + ((size_t)row * slots + sp) * kp;
    for (int c = 0; c < len; c += 32) {
      const unsigned long long v = c + lane < len ? lst[c + lane] : ~0ull;
      unsigned m = __ballot_sync(FULL, v < kth<S>(e, klane, kslot));
      if (m == 0u) break;  // the partial list is sorted: nothing later enters either
      do {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        merge<S>(e, __shfl_sync(FULL, v, src), lane);
      } while (m != 0u);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = lane * S + s;
    if (p < k) {
      out_d[(size_t)row * k + p] = e[s] == ~0ull ? CUDART_INF_F : __uint_as_float((unsigned)(e[s] >> 32));
      out_i[(size_t)row * k + p] = e[s] == ~0ull ? -1 : (int)(unsigned)e[s];
    }
  }
}

// The select instance (K > KMAX; see the note at the top).  Its distance
// pass at d <= 256: d2 of rows [r0, r1) against the key tiles [tps by,
// tps by + tps) into the chunk's rows d2_out (r1 - r0, n), self +inf: the
// K <= KMAX instances' rows (load_rows), key tiles (stage_key) and
// arithmetic (row_d2), without their lists.
template <int D>
__global__ void __launch_bounds__(THREADS, 2) pairwise_d2_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d_rt, int kt, int tps, int r0, int r1,
    float* __restrict__ d2_out) {
  constexpr int R = rows_per_warp<D, 1>();
  constexpr int DR = D > 0 ? D : 1;
  const int d = D > 0 ? D : d_rt;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;           // (d / V, kt, V): key tile
  float* skn = sk + kt * d;   // (kt,): key norms
  float* sq = skn + kt;       // (WARPS, d): the warp's query row (generic d only)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float q[R][DR];
  float qn[R];
  int row[R];
  bool live[R];
  load_rows<D, R>(x, norms, r1, d, r0 + (blockIdx.x * WARPS + warp) * R, lane, sq + warp * d, q, qn, row, live);
  const int split = blockIdx.y, k_end = min(n, (split + 1) * tps * kt);
  for (int k0 = split * tps * kt; k0 < k_end; k0 += kt) {
    const int rows = min(kt, k_end - k0);
    __syncthreads();  // the previous key tile is consumed
    for (int r = tid; r < rows; r += THREADS)
      stage_key<D>(x + (size_t)(k0 + r) * d, r, kt, d, norms != nullptr ? norms + k0 + r : nullptr, sk, skn);
    __syncthreads();
    for (int b = 0; b < rows; b += 32) {
      const int kr = b + lane, col = k0 + kr;
      float d2[R];
      row_d2<D, R>(q, qn, sq + warp * d, sk, skn, kt, kr, d, d2);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r] && kr < rows) d2_out[(size_t)(row[r] - r0) * n + col] = col == row[r] ? CUDART_INF_F : d2[r];
    }
  }
}

// The select instance's distance pass above d = 256: block (bx, by) writes
// the d2 tile of rows r0 + BM bx.. (those below r1) against keys BN by..,
// the sliced instance's product (sliced_d2_tile), into the chunk's rows.
__global__ void __launch_bounds__(THREADS, 1) pairwise_d2_sliced_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d, int r0, int r1,
    float* __restrict__ d2_out) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                // STAGES x (BM query rows, BN key rows) x BKP: the slices
  float* uni = stage + STAGE_FLOATS;  // the panel totals, then the d2 tile (BM, SD2)
  const int m0 = r0 + blockIdx.x * BM, k0 = blockIdx.y * BN;
  sliced_d2_tile(x, norms, n, d, m0, k0, stage, uni);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BM && m0 + r < r1; r += WARPS)
    for (int c = lane; c < BN && k0 + c < n; c += 32) d2_out[(size_t)(m0 + r - r0) * n + k0 + c] = uni[r * SD2 + c];
}

struct SelectState {
  unsigned bin, below, count;
};

// The digits of a 64-bit key (d2's bits above the index), from the top:
// d2's 32 bits as 11 + 11 + 10, the index's as 11 + 10 + 11.
__device__ __forceinline__ void key_digit(int p, int& shift, int& bits) {
  shift = p == 0 ? 53 : p == 1 ? 42 : p == 2 ? 32 : p == 3 ? 21 : p == 4 ? 11 : 0;
  bits = p == 2 || p == 4 ? 10 : 11;
}

// Bin b of the block's histogram (nb bins) with cum(< b) < rem <= cum(<= b),
// into st->bin, and cum(< b) into st->below: a block scan over the bins.
__device__ __forceinline__ void find_bin(const unsigned* hist, int nb, unsigned rem, unsigned* warp_sums,
                                         SelectState* st) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = nb / THREADS, b0 = tid * per;
  unsigned s = 0;
  for (int q = 0; q < per; ++q) s += hist[b0 + q];
  unsigned inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  unsigned below = inc - s;
  for (int w = 0; w < warp; ++w) below += warp_sums[w];
  if (below < rem && rem <= below + s) {  // one thread's bins hold the crossing
    for (int q = 0; q < per; ++q) {
      const unsigned h = hist[b0 + q];
      if (below + h >= rem) {
        st->bin = b0 + q, st->below = below;
        break;
      }
      below += h;
    }
  }
  __syncthreads();
}

// The largest key T such that exactly `rank` of row `self`'s keys (self
// excluded) are at most T: a radix select, a digit a pass from the top,
// each pass a shared-memory histogram (warp-aggregated atomics) of the keys
// that share the digits chosen so far.  Where the chosen bin holds exactly
// the keys still wanted, T is the bin's largest possible key and the passes
// stop; the last digit's bins hold one key each.  Keys are unique (the
// index is in them), so the set does not depend on the order of the
// atomics: among keys with equal d2 the lower indices come first.
__device__ unsigned long long select_rank(const unsigned* __restrict__ u, int n, int self, unsigned rank,
                                          unsigned* hist, unsigned* warp_sums, SelectState* st) {
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0, mask = 0;
  unsigned rem = rank;
  for (int p = 0; p < 6; ++p) {
    int shift, bits;
    key_digit(p, shift, bits);
    const int nb = 1 << bits;
    for (int b = threadIdx.x; b < nb; b += THREADS) hist[b] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += THREADS) {  // whole warps, for __match_any_sync
      const int j = j0 + threadIdx.x;
      const unsigned long long key = j < n ? (unsigned long long)u[j] << 32 | (unsigned)j : 0;
      const bool in = j < n && j != self && (key & mask) == prefix;
      const unsigned bin = in ? (unsigned)(key >> shift) & (nb - 1) : ~0u;
      const unsigned peers = __match_any_sync(FULL, bin);
      if (in && __ffs(peers) - 1 == lane) atomicAdd(&hist[bin], (unsigned)__popc(peers));
    }
    __syncthreads();
    find_bin(hist, nb, rem, warp_sums, st);
    const unsigned b = st->bin, count = hist[b];
    rem -= st->below;
    prefix |= (unsigned long long)b << shift;
    mask |= (unsigned long long)(nb - 1) << shift;
    __syncthreads();  // every thread has read the bin before the next pass clears it
    if (count == rem) return prefix | ~mask;
  }
  return prefix;
}

// The select instance's second pass: block b takes row self = r0 + b of
// the chunk (d2, (rows, n)) and writes its k smallest keys in ascending
// order, sort_tile (a power of two) at a time: the threshold of the ranks
// so far (select_rank), the keys between the last threshold and this one
// gathered into shared memory (any order), a bitonic sort there, written
// out as (d2, index).
__global__ void __launch_bounds__(THREADS) pairwise_topk_select_kernel(
    const float* __restrict__ d2, int n, int r0, int k, int sort_tile, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned long long keys[];  // (sort_tile,)
  __shared__ unsigned hist[SEL_BINS];
  __shared__ unsigned warp_sums[WARPS];
  __shared__ SelectState st;
  const int tid = threadIdx.x, self = r0 + blockIdx.x;
  const unsigned* u = reinterpret_cast<const unsigned*>(d2 + (size_t)blockIdx.x * n);
  unsigned long long lo = 0;
  for (int c0 = 0; c0 < k; c0 += sort_tile) {
    const int m = min(k - c0, sort_tile);
    const unsigned long long hi = select_rank(u, n, self, (unsigned)(c0 + m), hist, warp_sums, &st);
    if (tid == 0) st.count = 0;
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) {
      const unsigned long long key = (unsigned long long)u[j] << 32 | (unsigned)j;
      if (j != self && key <= hi && (c0 == 0 || key > lo)) {
        const unsigned at = atomicAdd(&st.count, 1u);
        if (at < (unsigned)m) keys[at] = key;
      }
    }
    const int len = pow2_at_least(m);
    for (int p = m + tid; p < len; p += THREADS) keys[p] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= len; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < len / 2; t += THREADS) {
          const int a = 2 * t - (t & (stride - 1)), b = a + stride;
          const unsigned long long ka = keys[a], kb = keys[b];
          if ((ka > kb) == ((a & size) == 0)) keys[a] = kb, keys[b] = ka;
        }
        __syncthreads();
      }
    for (int p = tid; p < m; p += THREADS) {
      const unsigned long long v = keys[p];
      out_d[(size_t)self * k + c0 + p] = __uint_as_float((unsigned)(v >> 32));
      out_i[(size_t)self * k + c0 + p] = (int)(unsigned)v;
    }
    lo = hi;
    __syncthreads();  // the keys are written out before the next tile gathers
  }
}

// The streamed select's rows a warp: two where a row sits in registers
// below d = 32 (one key staged from shared memory serves both), else one.
template <int D>
__host__ __device__ constexpr int stream_rows() { return D > 0 && D < 32 ? 2 : 1; }

// A key T such that `rank` to `rank + slack` of the `cnt` keys in buf (a
// warp's buffer in shared memory; keys unique, 1 <= rank < cnt) are at most
// T; with slack 0, the largest key T with exactly `rank` keys at most T.  A
// radix select by the warp, DIGIT_BITS a pass from the highest bit in which
// the keys differ (so the first pass spreads them over the bins), each pass
// a histogram in `hist` (DIGIT_BINS counters) of the keys that share the
// digits chosen so far.  Where the bin that holds the rank-th key holds at
// most `slack` keys past it, T is the bin's largest possible key; the last
// digit's bins hold one key each.
__device__ unsigned long long warp_select(const unsigned long long* buf, int cnt, unsigned rank, unsigned slack,
                                          unsigned* hist, int lane) {
  __syncwarp();  // the lanes' appends are visible
  unsigned long long lo = ~0ull, hi = 0;
#pragma unroll 4
  for (int j = lane; j < cnt; j += 32) {
    const unsigned long long v = buf[j];
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_xor_sync(FULL, lo, o), b = __shfl_xor_sync(FULL, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  int top = 63 - __clzll((long long)(lo ^ hi));  // lo != hi: at least two unique keys
  unsigned long long mask = top == 63 ? 0ull : ~0ull << (top + 1), prefix = lo & mask;
  unsigned rem = rank;
  for (;;) {
    const int low = top >= DIGIT_BITS - 1 ? top - (DIGIT_BITS - 1) : 0;
    const unsigned nb = 1u << (top - low + 1);
#pragma unroll
    for (int q = 0; q < DIGIT_BINS / 32; ++q) hist[q * 32 + lane] = 0;
    __syncwarp();
#pragma unroll 4
    for (int j = lane; j < cnt; j += 32) {
      const unsigned long long v = buf[j];
      if ((v & mask) == prefix) atomicAdd(&hist[(unsigned)(v >> low) & (nb - 1)], 1u);
    }
    __syncwarp();
    // lane l holds bins [8 l, 8 l + 8): its sum, a scan over the lanes, and
    // the lane whose bins the rank crosses walks them
    unsigned h[DIGIT_BINS / 32], s = 0;
#pragma unroll
    for (int q = 0; q < DIGIT_BINS / 32; ++q) s += h[q] = hist[lane * (DIGIT_BINS / 32) + q];
    unsigned inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += v;
    }
    const int src = __ffs(__ballot_sync(FULL, inc - s < rem && rem <= inc)) - 1;
    unsigned below = inc - s, bin = 0, count = 0;
    bool found = false;
#pragma unroll
    for (int q = 0; q < DIGIT_BINS / 32; ++q) {
      if (!found && below + h[q] >= rem) found = true, bin = lane * (DIGIT_BINS / 32) + q, count = h[q];
      if (!found) below += h[q];
    }
    bin = __shfl_sync(FULL, bin, src), below = __shfl_sync(FULL, below, src), count = __shfl_sync(FULL, count, src);
    rem -= below;
    prefix |= (unsigned long long)bin << low;
    mask |= (unsigned long long)(nb - 1) << low;
    __syncwarp();  // every lane has read the bins before the next pass clears them
    if (count - rem <= slack) return prefix | ~mask;
    top = low - 1;
  }
}

// Keeps the keys of buf (cnt of them) at most t at the front, in their
// order, and returns how many; moves the others to `high` in their order
// where it is not null (past buf's keys), else drops them.  A ballot a round
// of 32, each key written at the count of the keys before it that go the
// same way (a kept key at or below its own place, read in this round or
// before).
__device__ int warp_partition(unsigned long long* buf, int cnt, unsigned long long t, unsigned long long* high,
                              int lane) {
  const unsigned below_lane = (1u << lane) - 1;
  int lo = 0, hi = 0;
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const int j = j0 + lane;
    const unsigned long long v = j < cnt ? buf[j] : ~0ull;
    const bool keep = j < cnt && v <= t, move = j < cnt && !keep && high != nullptr;
    const unsigned mk = __ballot_sync(FULL, keep), mm = __ballot_sync(FULL, move);
    if (keep) buf[lo + __popc(mk & below_lane)] = v;
    if (move) high[hi + __popc(mm & below_lane)] = v;
    lo += __popc(mk), hi += __popc(mm);
  }
  __syncwarp();
  return lo;
}

// Sorts buf[0, len) ascending in place (len a power of two): a bitonic
// network by the warp, a pair a lane at a time.
__device__ void warp_bitonic(unsigned long long* buf, int len, int lane) {
  __syncwarp();  // the lanes' keys are visible
  for (int size = 2; size <= len; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < len / 2; t += 32) {
        const int a = 2 * t - (t & (stride - 1)), b = a + stride;
        const unsigned long long ka = buf[a], kb = buf[b];
        if ((ka > kb) == ((a & size) == 0)) buf[a] = kb, buf[b] = ka;
      }
      __syncwarp();
    }
}

// The streamed select (K > KMAX at d <= 256, K <= KSTREAM; see the note at
// the top).  A warp owns R = stream_rows<D>() rows and, for each, a buffer
// of `slots` keys in shared memory and a threshold tau: the keys at most tau
// are the row's candidates.  The block's warps share each key tile, as the
// list instances do (load_rows, stage_key, row_d2: the same bits).  A
// round's candidates go into the buffer at a warp-aggregated offset (a
// ballot and a popcount); where `cap` keys would be exceeded, the warp
// selects the K-th smallest key of the buffer (warp_select), sets tau to it
// and keeps the K keys at most tau (and a few more: a compaction in the
// sweep may stop a radix pass early).  After the sweep the warp selects the
// K smallest exactly, sorts them in shared memory (the largest power of two
// of them and the rest apart) and writes them.
template <int D>
__global__ void __launch_bounds__(THREADS, 2) pairwise_topk_stream_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d_rt, int k, int kt, int slots,
    int cap, float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int R = stream_rows<D>();
  constexpr int DR = D > 0 ? D : 1;
  const int d = D > 0 ? D : d_rt;
  const int warps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  auto* buf = reinterpret_cast<unsigned long long*>(smem);          // (warps, R, slots): the buffers
  auto* hist = reinterpret_cast<unsigned*>(buf + (size_t)warps * R * slots);  // (warps, DIGIT_BINS)
  float* sk = reinterpret_cast<float*>(hist + warps * DIGIT_BINS);  // (d / V, kt, V): key tile
  float* skn = sk + kt * d;                                          // (kt,): key norms
  float* sq = skn + kt;                                              // (warps, d): query rows (generic d)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (blockIdx.x * warps + warp) * R;
  unsigned long long* wbuf = buf + (size_t)warp * R * slots;
  unsigned* whist = hist + warp * DIGIT_BINS;
  const unsigned below_lane = (1u << lane) - 1;
  // a compaction keeps K keys and at most an eighth of the room past the
  // next round's 32 more (a looser tau for fewer radix passes; cap >= k + 32)
  const unsigned slack = (unsigned)(cap - k - 32) / 8;

  float q[R][DR];
  float qn[R];
  int row[R];
  bool live[R];
  load_rows<D, R>(x, norms, n, d, row0, lane, sq + warp * d, q, qn, row, live);
  unsigned long long tau[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tau[r] = ~0ull, cnt[r] = 0;

  for (int k0 = 0; k0 < n; k0 += kt) {
    const int rows = min(kt, n - k0);
    __syncthreads();  // the previous key tile is consumed
    for (int r = tid; r < rows; r += blockDim.x)
      stage_key<D>(x + (size_t)(k0 + r) * d, r, kt, d, norms != nullptr ? norms + k0 + r : nullptr, sk, skn);
    __syncthreads();
    // One 32-key round: lane l takes key b + l against the warp's R rows;
    // only a round at the end of the keys, over the warp's own rows or in
    // the last block runs the masks.
    auto sweep_round = [&](const int b, auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
      const int kr = b + lane, col = k0 + kr;
      float d2[R];
      row_d2<D, R>(q, qn, sq + warp * d, sk, skn, kt, kr, d, d2);
      unsigned long long key[R];
      bool cand[R];
      unsigned m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = (unsigned long long)__float_as_uint(d2[r]) << 32 | (unsigned)col;
        cand[r] = key[r] <= tau[r];
        if constexpr (MASKED) cand[r] = cand[r] && live[r] && kr < rows && col != row[r];
        m[r] = __ballot_sync(FULL, cand[r]);
      }
      // a buffer that a round could overflow (the fullest within 32 of
      // cap) is compacted first where this round's candidates overflow it
      int fullest = cnt[0];
#pragma unroll
      for (int r = 1; r < R; ++r) fullest = max(fullest, cnt[r]);
      if (fullest + 32 > cap) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (cnt[r] + __popc(m[r]) <= cap) continue;  // else cnt[r] > k + slack: cap >= k + 32 + slack
          tau[r] = warp_select(wbuf + r * slots, cnt[r], (unsigned)k, slack, whist, lane);
          cnt[r] = warp_partition(wbuf + r * slots, cnt[r], tau[r], nullptr, lane);
          cand[r] = cand[r] && key[r] <= tau[r];
          m[r] = __ballot_sync(FULL, cand[r]);
        }
      }
      // the appends: a candidate goes in at the count of the candidates of
      // lower lanes
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cand[r]) wbuf[r * slots + cnt[r] + __popc(m[r] & below_lane)] = key[r];
        cnt[r] += __popc(m[r]);
      }
    };
    for (int b = 0; b < rows; b += 32) {
      const int c0 = k0 + b;
      // a vote, so that the compiler sees a warp-uniform branch
      if (__all_sync(FULL, b + 32 <= rows && row0 + R <= n && (row0 + R <= c0 || row0 >= c0 + 32)))
        sweep_round(b, std::false_type{});
      else
        sweep_round(b, std::true_type{});
    }
  }
  // the K smallest of each row's buffer (it holds at least K keys: a key
  // left out is above K kept ones), sorted: the P2 smallest (P2 the largest
  // power of two at most K) by a bitonic sort, the other K - P2 apart: up to
  // 16 of them one warp minimum at a time (K = 263: 256 and 7), more by a
  // second select and a bitonic sort of their own, padded
  const int p2 = pow2_at_least(k + 1) / 2, tail = k - p2, tail_len = tail > 0 ? pow2_at_least(tail) : 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live[r]) continue;  // warp-uniform
    unsigned long long* rb = wbuf + r * slots;
    float* od = out_d + (size_t)row[r] * k;
    int* oi = out_i + (size_t)row[r] * k;
    if (tail > 0 && tail <= 16) {
      const unsigned long long t = warp_select(rb, cnt[r], (unsigned)p2, 0, whist, lane);
      unsigned long long last = t, mine = 0;
      for (int i = 0; i < tail; ++i) {  // the i-th key past t, in lane i
        unsigned long long m = ~0ull;
        for (int j = lane; j < cnt[r]; j += 32) {
          const unsigned long long v = rb[j];
          m = v > last && v < m ? v : m;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const unsigned long long v = __shfl_xor_sync(FULL, m, o);
          m = v < m ? v : m;
        }
        last = m;
        mine = lane == i ? m : mine;
      }
      warp_partition(rb, cnt[r], t, nullptr, lane);
      warp_bitonic(rb, p2, lane);
      if (lane < tail) od[p2 + lane] = __uint_as_float((unsigned)(mine >> 32)), oi[p2 + lane] = (int)(unsigned)mine;
    } else {
      if (cnt[r] > k) warp_partition(rb, cnt[r], warp_select(rb, cnt[r], (unsigned)k, 0, whist, lane), nullptr, lane);
      if (tail > 0) warp_partition(rb, k, warp_select(rb, k, (unsigned)p2, 0, whist, lane), rb + k, lane);
      for (int p = k + tail + lane; p < k + tail_len; p += 32) rb[p] = ~0ull;
      warp_bitonic(rb, p2, lane);
      if (tail > 0) warp_bitonic(rb + k, tail_len, lane);
      for (int p = p2 + lane; p < k; p += 32) {
        const unsigned long long v = rb[k + p - p2];
        od[p] = __uint_as_float((unsigned)(v >> 32)), oi[p] = (int)(unsigned)v;
      }
    }
    for (int p = lane; p < p2; p += 32) {
      const unsigned long long v = rb[p];
      od[p] = __uint_as_float((unsigned)(v >> 32)), oi[p] = (int)(unsigned)v;
    }
  }
}

// The key split of the sliced instance: key tiles a block (tps) and
// splits, so that the blocks fill the card's resident slots in as few
// waves, and as few tiles a block, as the shape allows.
struct Split {
  int tps, splits;
};
Split plan_split(int n, int slots) {
  const int row_tiles = (n + BM - 1) / BM, key_tiles = (n + BN - 1) / BN;
  Split best{key_tiles, 1};
  long best_cost = -1;
  for (int tps = key_tiles; tps >= 1; --tps) {
    const int splits = (key_tiles + tps - 1) / tps;
    const long waves = ((long)row_tiles * splits + slots - 1) / slots;
    const long cost = waves * tps;
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = Split{tps, splits};
  }
  return best;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// workspace bytes: |x|^2 (n floats) where d > 32, and the sliced
// instance's partial lists
template <int S>
int launch_sliced(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
                  int* occ, void* work, size_t* work_bytes) {
  cudaError_t e = cudaFuncSetAttribute(pairwise_topk_sliced_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SLICED_SMEM);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairwise_topk_sliced_kernel<S>, THREADS,
                                                    SLICED_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (occ != nullptr) {
    occ[0] = per_sm, occ[1] = THREADS, occ[2] = (int)SLICED_SMEM, occ[3] = BN;
    return 0;
  }
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  // mirrored where a partial list per (row, key tile) fits the budget (a
  // tile's list holds at most BN entries), else the keys split
  const int key_tiles = (n + BN - 1) / BN, kp_mirror = 32 * S < BN ? 32 * S : BN;
  const bool mirror = (size_t)n * key_tiles * kp_mirror * sizeof(unsigned long long) <= mirror_budget;
  const Split sp = mirror ? Split{1, key_tiles} : plan_split(n, (per_sm > 0 ? per_sm : 1) * sms);
  const int slots = mirror ? key_tiles : sp.splits, kp = mirror ? kp_mirror : 32 * S;
  const size_t norm_bytes = align256((size_t)n * sizeof(float));
  const size_t bytes = norm_bytes + (size_t)n * slots * kp * sizeof(unsigned long long);
  if (work_bytes != nullptr) {
    *work_bytes = bytes;
    return 0;
  }
  float* norms = static_cast<float*>(work);
  auto* lists = reinterpret_cast<unsigned long long*>(static_cast<char*>(work) + norm_bytes);
  if ((e = (cudaError_t)launch_norms(x, n, d, norms, stream)) != cudaSuccess) return (int)e;
  const dim3 grid = mirror ? dim3(key_tiles * (key_tiles + 1) / 2) : dim3((n + BM - 1) / BM, sp.splits);
  pairwise_topk_sliced_kernel<S><<<grid, THREADS, SLICED_SMEM, stream>>>(x, norms, n, d, k, sp.tps, mirror, slots,
                                                                         kp, lists);
  pairwise_topk_merge_kernel<S><<<(n + WARPS - 1) / WARPS, THREADS, 0, stream>>>(lists, n, k, slots, kp, out_d,
                                                                                 out_i);
  return (int)cudaGetLastError();
}

// The key tile of the d <= 256 instances (keys staged at once, a multiple
// of 32) and their dynamic shared memory: the tile, its norms and, at a
// generic d, each warp's query row, within SMEM_BUDGET.
template <int D>
void tile_plan(int d, int* kt, size_t* smem) {
  const int q_floats = D > 0 ? 0 : WARPS * d;
  const int fit = (SMEM_BUDGET / (int)sizeof(float) - q_floats) / (d + 1);
  *kt = (fit < KEY_TILE ? fit : KEY_TILE) / 32 * 32;
  *smem = (size_t)(*kt * d + *kt + q_floats) * sizeof(float);
}

// Launches the <D, S> instance, or with `occ` set only reports its blocks per
// SM, threads per block, dynamic shared memory and key tile into occ[0..3],
// or with `work_bytes` set only the workspace it needs.
template <int D, int S>
int launch(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
           int* occ, void* work, size_t* work_bytes) {
  const bool pre = D == 0 && d > 32;  // |x|^2 in windows of 32 from the pre-pass
  if (work_bytes != nullptr) {
    *work_bytes = pre ? (size_t)n * sizeof(float) : 0;
    return 0;
  }
  int kt;
  size_t smem;
  tile_plan<D>(d, &kt, &smem);
  if (kt < 32) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        pairwise_topk_kernel<D, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    occ[1] = THREADS, occ[2] = (int)smem, occ[3] = kt;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, pairwise_topk_kernel<D, S>, THREADS, smem);
  }
  float* norms = pre ? static_cast<float*>(work) : nullptr;
  if (pre) {
    const int e = launch_norms(x, n, d, norms, stream);
    if (e != 0) return e;
  }
  constexpr int R = rows_per_warp<D, S>();
  const int rows_per_block = WARPS * R;
  pairwise_topk_kernel<D, S><<<(n + rows_per_block - 1) / rows_per_block, THREADS, smem, stream>>>(
      x, norms, n, d, k, kt, out_d, out_i);
  return (int)cudaGetLastError();
}

// D = -1 is the sliced instance.
template <int D>
int launch_d(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
             int* occ, void* work, size_t* work_bytes) {
#define REPRO_TOPK_S(S)                                                                             \
  case S:                                                                                           \
    return D < 0 ? launch_sliced<S>(x, n, d, k, out_d, out_i, stream, occ, work, work_bytes)       \
                 : launch<(D < 0 ? 0 : D), S>(x, n, d, k, out_d, out_i, stream, occ, work, work_bytes);
  switch ((k + 31) / 32) {
    REPRO_TOPK_S(1) REPRO_TOPK_S(2) REPRO_TOPK_S(3) REPRO_TOPK_S(4)
    REPRO_TOPK_S(5) REPRO_TOPK_S(6) REPRO_TOPK_S(7) REPRO_TOPK_S(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_TOPK_S
}

// The select instance's distance pass for rows [r0, r1) at width D (D < 0:
// above 256), into d2.
template <int D>
int launch_d2(const float* x, const float* norms, int n, int d, int r0, int r1, float* d2, int sms,
              cudaStream_t stream) {
  cudaError_t e;
  if constexpr (D < 0) {
    e = cudaFuncSetAttribute(pairwise_d2_sliced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SLICED_SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((r1 - r0 + BM - 1) / BM, (n + BN - 1) / BN);
    pairwise_d2_sliced_kernel<<<grid, THREADS, SLICED_SMEM, stream>>>(x, norms, n, d, r0, r1, d2);
  } else {
    int kt;
    size_t smem;
    tile_plan<D>(d, &kt, &smem);
    if (kt < 32) return (int)cudaErrorInvalidValue;
    if (smem > (size_t)SMEM_DEFAULT) {
      e = cudaFuncSetAttribute(pairwise_d2_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    constexpr int R = rows_per_warp<D, 1>();
    const int blocks = (r1 - r0 + WARPS * R - 1) / (WARPS * R), key_tiles = (n + kt - 1) / kt;
    // the keys split so that the grid fills two waves of two blocks an SM
    int splits = (4 * sms + blocks - 1) / blocks;
    splits = splits < 1 ? 1 : (splits > key_tiles ? key_tiles : splits);
    const int tps = (key_tiles + splits - 1) / splits;
    pairwise_d2_kernel<D><<<dim3(blocks, (key_tiles + tps - 1) / tps), THREADS, smem, stream>>>(
        x, norms, n, d, kt, tps, r0, r1, d2);
  }
  return (int)cudaGetLastError();
}

// Rows of d2 a chunk of the select instance holds: select_budget bytes in
// whole tiles of BM rows, at least one tile, at most n rows.
size_t select_rows(int n) {
  size_t rows = select_budget / ((size_t)n * sizeof(float)) / BM * BM;
  rows = rows < (size_t)BM ? (size_t)BM : rows;
  return rows < (size_t)n ? rows : (size_t)n;
}

// The select instance (K > KMAX), with launch()'s occ / work_bytes contract;
// occ reports the selecting kernel, whose key tile is its sort tile.
// Workspace: |x|^2 (n floats) where d > 32, and one chunk of d2 rows.
int launch_select(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream, int* occ,
                  void* work, size_t* work_bytes) {
  const int sort_tile = pow2_at_least(k < sort_max ? k : sort_max);
  const size_t sel_smem = (size_t)sort_tile * sizeof(unsigned long long);
  cudaError_t e;
  if (sel_smem > (size_t)SMEM_DEFAULT) {
    e = cudaFuncSetAttribute(pairwise_topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    occ[1] = THREADS, occ[2] = (int)sel_smem, occ[3] = sort_tile;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, pairwise_topk_select_kernel, THREADS, sel_smem);
  }
  const bool pre = d > 32;  // |x|^2 in windows of 32 from the pre-pass
  const size_t rows = select_rows(n), norm_bytes = pre ? align256((size_t)n * sizeof(float)) : 0;
  if (work_bytes != nullptr) {
    *work_bytes = norm_bytes + rows * n * sizeof(float);
    return 0;
  }
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  float* norms = pre ? static_cast<float*>(work) : nullptr;
  float* d2 = reinterpret_cast<float*>(static_cast<char*>(work) + norm_bytes);
  if (pre) {
    const int s = launch_norms(x, n, d, norms, stream);
    if (s != 0) return s;
  }
  for (int r0 = 0; r0 < n; r0 += (int)rows) {
    const int r1 = r0 + (int)rows < n ? r0 + (int)rows : n;
    int s;
    switch (d > MAX_D_TILED ? -1 : d) {
      case -1: s = launch_d2<-1>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      case 2: s = launch_d2<2>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      case 4: s = launch_d2<4>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      case 8: s = launch_d2<8>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      case 16: s = launch_d2<16>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      case 32: s = launch_d2<32>(x, norms, n, d, r0, r1, d2, sms, stream); break;
      default: s = launch_d2<0>(x, norms, n, d, r0, r1, d2, sms, stream); break;
    }
    if (s != 0) return s;
    pairwise_topk_select_kernel<<<r1 - r0, THREADS, sel_smem, stream>>>(d2, n, r0, k, sort_tile, out_d, out_i);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

// The streamed select's block at width D and K = k: the most warps (a
// power of two, at most WARPS) whose R rows' buffers hold the sorted list
// and half a list of appends (at least 32), each buffer as many keys
// (`slots`, a multiple of 32) as STREAM_BUF_BUDGET allows and a key tile of
// STREAM_MIN_TILE keys leaves room for (K = 263 at d = 8: 576); the
// compaction's trigger (`cap`); the key tile that the rest of STREAM_SMEM
// holds (a multiple of 32, at most KEY_TILE) and the block's dynamic shared
// memory.
struct StreamPlan {
  int warps, slots, cap, kt;
  size_t smem;
};
template <int D>
StreamPlan stream_plan(int d, int k) {
  constexpr int R = stream_rows<D>();
  // half a list of appends (at least 32), and the end's sort of the keys
  // past the largest power of two at most K, padded
  const int tail = k - pow2_at_least(k + 1) / 2;
  const int room = k / 2 > 32 ? k / 2 : 32, tail_len = tail > 0 ? pow2_at_least(tail) : 0;
  const int need = k + (room > tail_len ? room : tail_len);
  const size_t tile_min = (size_t)STREAM_MIN_TILE * (d + 1) * sizeof(float);
  int warps = WARPS, slots = 0;
  size_t other = 0;
  for (;; warps >>= 1) {
    other = (size_t)warps * DIGIT_BINS * 4 + (D > 0 ? 0 : (size_t)warps * d * sizeof(float));
    size_t budget = STREAM_SMEM > other + tile_min ? STREAM_SMEM - other - tile_min : 0;
    budget = budget < (size_t)STREAM_BUF_BUDGET ? budget : (size_t)STREAM_BUF_BUDGET;
    slots = (int)(budget / ((size_t)warps * R * sizeof(unsigned long long))) / 32 * 32;
    if (slots >= need || warps == 1) break;
  }
  int cap = stream_cap > 0 ? stream_cap : slots;
  cap = cap < k + 32 ? k + 32 : (cap > slots ? slots : cap);
  const size_t fixed = (size_t)warps * R * slots * sizeof(unsigned long long) + other;
  const long fit = fixed < (size_t)STREAM_SMEM ? (long)((STREAM_SMEM - fixed) / sizeof(float)) / (d + 1) : 0;
  const int kt = (int)(fit < KEY_TILE ? fit : KEY_TILE) / 32 * 32;
  return StreamPlan{warps, slots, cap, kt, fixed + (size_t)kt * (d + 1) * sizeof(float)};
}

// The streamed select (KMAX < K <= KSTREAM at d <= 256), with launch()'s
// occ / work_bytes contract.  Workspace: |x|^2 (n floats) where d > 32; the
// candidate buffers live in shared memory.
template <int D>
int launch_stream(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream, int* occ,
                  void* work, size_t* work_bytes) {
  const bool pre = D == 0 && d > 32;  // |x|^2 in windows of 32 from the pre-pass
  if (work_bytes != nullptr) {
    *work_bytes = pre ? (size_t)n * sizeof(float) : 0;
    return 0;
  }
  const StreamPlan p = stream_plan<D>(d, k);
  if (p.kt < 32 || p.slots < k + 32 || p.slots < k + pow2_at_least(k - pow2_at_least(k + 1) / 2))
    return (int)cudaErrorInvalidValue;
  if (p.smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(pairwise_topk_stream_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    occ[1] = 32 * p.warps, occ[2] = (int)p.smem, occ[3] = p.kt;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, pairwise_topk_stream_kernel<D>, 32 * p.warps,
                                                              p.smem);
  }
  float* norms = pre ? static_cast<float*>(work) : nullptr;
  if (pre) {
    const int e = launch_norms(x, n, d, norms, stream);
    if (e != 0) return e;
  }
  const int rows_per_block = p.warps * stream_rows<D>();
  pairwise_topk_stream_kernel<D><<<(n + rows_per_block - 1) / rows_per_block, 32 * p.warps, p.smem, stream>>>(
      x, norms, n, d, k, p.kt, p.slots, p.cap, out_d, out_i);
  return (int)cudaGetLastError();
}

int dispatch(const float* x, int n, int d, int k, float* out_d, int* out_i, void* stream,
             int* occ, void* work, size_t* work_bytes) {
  if (n < 2 || d < 1 || k < 1 || k > n - 1 || reinterpret_cast<size_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // past the lists' 256 entries: the streamed select up to KSTREAM at
  // d <= 256, else the stored select (up to K = n - 1, at every width)
  if (k > stream_from && k <= KSTREAM && d <= MAX_D_TILED) {
    switch (d) {
      case 2: return launch_stream<2>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
      case 4: return launch_stream<4>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
      case 8: return launch_stream<8>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
      case 16: return launch_stream<16>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
      case 32: return launch_stream<32>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
      default: return launch_stream<0>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    }
  }
  if (k > KMAX) return launch_select(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
  if (d > MAX_D_TILED) return launch_d<-1>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
  switch (d) {
    case 2: return launch_d<2>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    case 4: return launch_d<4>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    case 8: return launch_d<8>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    case 16: return launch_d<16>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    case 32: return launch_d<32>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
    default: return launch_d<0>(x, n, d, k, out_d, out_i, s, occ, work, work_bytes);
  }
}

}  // namespace

// x: (n, d) float32 row-major, 16-byte aligned; out_d: (n, k) float32;
// out_i: (n, k) int32; work: repro_pairwise_topk_workspace bytes, 256-byte
// aligned (null where that is 0).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_pairwise_topk(const float* x, int n, int d, int k,
                                   float* out_d, int* out_i, void* work, void* stream) {
  return dispatch(x, n, d, k, out_d, out_i, stream, nullptr, work, nullptr);
}

// The workspace the launch for (n, d, k) needs on the current card, in bytes.
extern "C" int repro_pairwise_topk_workspace(int n, int d, int k, size_t* bytes) {
  return dispatch(nullptr, n, d, k, nullptr, nullptr, nullptr, nullptr, nullptr, bytes);
}

// The launch configuration the kernel takes for (n, d, k), without launching:
// occ = {blocks per SM, threads per block, dynamic shared memory bytes, key tile}.
extern "C" int repro_pairwise_topk_occupancy(int n, int d, int k, int* occ) {
  return dispatch(nullptr, n, d, k, nullptr, nullptr, nullptr, occ, nullptr, nullptr);
}

// x: (n, d) float32 -> out: (n,) |x|^2 of each row in XLA's windows of 32,
// the pre-pass alone (the SBCN tiles' norms, kernels/sbcn_tile.py).
extern "C" int repro_pairwise_topk_norms(const float* x, int n, int d, float* out, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return launch_norms(x, n, d, out, (cudaStream_t)stream);
}

// Sets the bytes the sliced instance's mirrored plan may take for partial
// lists, and returns the setting before; 0 makes every launch split the
// keys, so that the two plans can be timed at one shape.
extern "C" size_t repro_pairwise_topk_set_mirror_budget(size_t bytes) {
  const size_t before = mirror_budget;
  mirror_budget = bytes;
  return before;
}

// Sets the select instance's sort tile (keys sorted in shared memory at once,
// rounded up to a power of two) and its d2 chunk's bytes (whole tiles of 128
// rows, at least one), where a value is above 0, and returns the settings
// before through the pointers: small values run its loops over several
// tiles and chunks at a small n.
extern "C" void repro_pairwise_topk_set_select_plan(int sort_tile, size_t chunk_bytes, int* sort_before,
                                                    size_t* chunk_before) {
  *sort_before = sort_max, *chunk_before = select_budget;
  if (sort_tile > 0) sort_max = sort_tile;
  if (chunk_bytes > 0) select_budget = chunk_bytes;
}

// Sets the streamed select's compaction trigger (the keys a row's buffer
// holds before it selects; 0: the whole buffer; clamped to [K + 32, the
// buffer]) where cap >= 0, and the K above which the instance runs (up to
// KSTREAM; KMAX by default) where from >= 1, and returns the settings
// before through the pointers: a small cap runs many compactions at a small
// n, a small `from` runs the instance at short lists, KSTREAM turns it off.
extern "C" void repro_pairwise_topk_set_stream_plan(int cap, int from, int* cap_before, int* from_before) {
  *cap_before = stream_cap, *from_before = stream_from;
  if (cap >= 0) stream_cap = cap;
  if (from >= 1) stream_from = from;
}
