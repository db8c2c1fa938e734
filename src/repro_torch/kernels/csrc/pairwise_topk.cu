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
// with S <= 8 slots, so K <= 256; a merge moves entry p - 1 to p where the
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
// 32 row tiles of n = 4000 fill the card.  |x|^2 comes from a pre-pass, a
// warp a row, once a call.
//
// Arithmetic per pair, in the reference's order: d2 = fmaxf((qn + kn) -
// 2 dot, 0), with the norms and the dot product summed as XLA on the CPU
// sums the reference's top-K (its Pallas kernel in interpret mode, and its
// jnp twin): |x|^2 as an fmaf chain in index order at d = 2-4 and 9-32,
// unfused in index order at d = 5-8, and in XLA's windows of 32
// (xla_order.cuh) above 32 (kernels/ops.py::sum_order, program "topk");
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
#include "xla_order.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KMAX = 256;                // 8 slots of 32 lanes
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
constexpr int NORM_WARPS = 4;            // rows a block of the norms' pre-pass
constexpr int UNION_FLOATS = TM * TN * THREADS > BM * SD2 ? TM * TN * THREADS : BM * SD2;
constexpr size_t SLICED_SMEM = (size_t)(STAGE_FLOATS + UNION_FLOATS + BM) * sizeof(float);
static_assert(PANEL % BK == 0, "a panel ends on a slice boundary");
// the partial lists' bytes the mirrored plan may take (64 MiB; 0 splits the
// keys at every shape: repro_pairwise_topk_set_mirror_budget)
size_t mirror_budget = (size_t)64 << 20;

// the reference's order for |x|^2 at width D: unfused at d = 5-8, fmaf
// chains at the other widths a template instance takes (d > 32 reads a
// pre-pass's windows of 32)
__host__ __device__ constexpr bool seq_norm(int d) { return d >= 5 && d <= 8; }

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

// |x|^2 of each row in XLA's windows of 32 (kernels/ops.py::sum_sq_win32),
// the pre-pass of the d > 32 instances: a warp a row; lane l sums the
// first-level windows l, l + 32, ... in index order, and lane 0 sums the
// window sums in the tree's order
__global__ void __launch_bounds__(NORM_WARPS * 32) norms_win32_kernel(
    const float* __restrict__ x, int n, int d, float* __restrict__ out) {
  extern __shared__ float wsum[];  // (NORM_WARPS, W): the window sums
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int row = blockIdx.x * NORM_WARPS + wib;
  if (row >= n) return;  // warp-uniform
  const int w_n = (d + 31) / 32, pad = (32 * w_n - d) / 2;
  const float* r = x + (size_t)row * d;
  float* ws = wsum + wib * w_n;
  for (int w = lane; w < w_n; w += 32) {
    const int j0 = max(0, 32 * w - pad), j1 = min(d, 32 * w + 32 - pad);
    float s = __fmul_rn(r[j0], r[j0]);
    for (int j = j0 + 1; j < j1; ++j) s = __fadd_rn(s, __fmul_rn(r[j], r[j]));
    ws[w] = s;
  }
  __syncwarp();
  if (lane == 0) out[row] = tree_sum([&](int w) { return ws[w]; }, w_n);
}

int launch_norms(const float* x, int n, int d, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)NORM_WARPS * ((d + 31) / 32) * sizeof(float);
  if (smem > (size_t)SMEM_DEFAULT) return (int)cudaErrorInvalidValue;  // d > 98304
  norms_win32_kernel<<<(n + NORM_WARPS - 1) / NORM_WARPS, NORM_WARPS * 32, smem, stream>>>(x, n, d, out);
  return (int)cudaGetLastError();
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

// d <= 256.  `norms` holds |x|^2 from the pre-pass where d > 32, else null.
template <int D, int S>
__global__ void __launch_bounds__(THREADS, 2) pairwise_topk_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int n, int d_rt, int k, int kt,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int R = rows_per_warp<D, S>();
  constexpr int V = vec_width<D>();
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
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = row0 + r;
    live[r] = row[r] < n;
    qn[r] = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) q[r][j] = live[r] ? x[(size_t)row[r] * D + j] : 0.f;
      qn[r] = norm_of<D>(q[r]);
    }
  }
  if constexpr (D == 0) {
    float* qs = sq + warp * d;
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
      float kc[DR];
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
      // the R rows' distances first (independent FMA chains), then their
      // candidates: keys whose d2 is at most the row's K-th d2.  A tie on
      // d2 that loses on the index is merged too and only moves entries
      // past K.
      float d2[R];
      bool cand[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
        if constexpr (D > 0) {
#pragma unroll
          for (int j = 0; j < D; ++j) dot = fmaf(q[r][j], kc[j], dot);
        } else {
          const float* qs = sq + warp * d;
          for (int j = 0; j < d; ++j) dot = fmaf(qs[j], sk[j * kt + kr], dot);
        }
        d2[r] = fmaxf(qn[r] + kn - 2.f * dot, 0.f);
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
  const int ty = lane >> 3, tx = lane & 7, wm = warp >> 1, wn = warp & 1;
  const int key_tiles = (n + BN - 1) / BN;
  int rt = blockIdx.x, t_begin = blockIdx.y * tps, t_end = min(key_tiles, t_begin + tps);
  if (mirror) {
    int rem = blockIdx.x;
    for (rt = 0; rem >= key_tiles - rt; ++rt) rem -= key_tiles - rt;
    t_begin = rt + rem, t_end = t_begin + 1;
  }
  const int m0 = rt * BM;
  const int n_slices = (d + BK - 1) / BK;
  const bool vec = (d & 3) == 0;  // rows start on 16 bytes: 16-byte copies
  const int klane = (k - 1) / S, kslot = (k - 1) % S;
  for (int r = tid; r < BM; r += THREADS) thr[r] = FLT_MAX;

  // stage the slice [s0, s0 + BK) of the block's rows and of keys k0.. into
  // buffer b; past the last slice only an empty group, so that every
  // iteration waits for the same count
  auto issue = [&](int b, int k0, int s0) {
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
    // acc[i][j]: row wm 32 + ty + 4 i against key wn 64 + tx + 8 j
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = -0.f;  // fmaf(a, b, -0) is a b rounded: the first product
    bool folded = false;
#pragma unroll
    for (int b = 0; b < STAGES - 1; ++b) issue(b, k0, b * BK);
    for (int s = 0; s < n_slices; ++s) {
      issue((s + STAGES - 1) % STAGES, k0, (s + STAGES - 1) * BK);
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
    // the d2 tile; self pairs and keys past n are +inf, which never enters
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
  const int q_floats = D > 0 ? 0 : WARPS * d;
  int kt = (SMEM_BUDGET / (int)sizeof(float) - q_floats) / (d + 1);
  kt = (kt < KEY_TILE ? kt : KEY_TILE) / 32 * 32;
  if (kt < 32) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kt * d + kt + q_floats) * sizeof(float);
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

int dispatch(const float* x, int n, int d, int k, float* out_d, int* out_i, void* stream,
             int* occ, void* work, size_t* work_bytes) {
  if (n < 2 || d < 1 || k < 1 || k > KMAX || k > n - 1 || reinterpret_cast<size_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
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

// Sets the bytes the sliced instance's mirrored plan may take for partial
// lists, and returns the setting before; 0 makes every launch split the
// keys, so that the two plans can be timed at one shape.
extern "C" size_t repro_pairwise_topk_set_mirror_budget(size_t bytes) {
  const size_t before = mirror_budget;
  mirror_budget = bytes;
  return before;
}
