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
// What bounds it on the H100: operations.  The distance sweep is n^2 (2d + 3)
// float32 operations (n = 16000, d = 8: 4.9e9) on the FMA pipes, 67 TFLOP/s
// at most; the bytes are n * d * 4 in and n * K * 8 out, negligible beside
// that.  The top-K adds one compare per (row, key) and, per accepted key, a
// merge step; after the list fills, a key is accepted with probability about
// K / (keys seen), so a row accepts about K ln(n / K) keys of its n.
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
// A warp owns its rows, so there are no atomics and no second pass.
//
// Above d = 256 a key tile of 32 rows no longer fits shared memory beside
// the query rows (d = 1536: 196 KB), so the sliced instance streams d in
// slices of SLICE floats: for each tile of TILE keys, each slice of the key
// rows (and of each warp's query row) is staged in turn, and each lane
// carries the dot products of its TILE / 32 keys across the slices in
// registers, and the staging thread carries its key's |k|^2 in shared
// memory.  One accumulator runs on over the slices, so each sum is the same
// single fmaf chain in index order as at any other width (partial sums per
// slice would round differently).  The rounds of candidates then run as
// below, on the finished tile.
//
// Arithmetic per pair, as the first version of this kernel: |q|^2, |k|^2 and
// q.k as fmaf chains in index order from 0, then fmaxf(qn + kn - 2 dot, 0).
// Products are plain float32 FFMA: no tensor cores, hence no TF32, which the
// downstream tie tolerances do not allow for (and at d = 8 a depth-8 product
// gains nothing from wgmma).

#include <cuda_runtime.h>
#include <cfloat>
#include <type_traits>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KMAX = 256;                // 8 slots of 32 lanes
constexpr int TILE = 256;                // sliced instance: keys per tile, one per thread
constexpr int SLICE = 64;                // sliced instance: floats of d per staged slice
constexpr int MAX_D_TILED = 256;         // above this width the sliced instance runs
constexpr int KEY_TILE = 1024;           // keys staged per tile at most
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, dynamic smem needs an opt-in
constexpr int SMEM_BUDGET = 96 * 1024;   // two blocks per SM

template <int D>
__host__ __device__ constexpr int vec_width() { return D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1); }

template <int D, int S>
__host__ __device__ constexpr int rows_per_warp() {
  return S > 4 || D == 0 || D >= 32 ? 1 : (D >= 16 ? 2 : 4);
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

// Stage key row `r` of the tile: coordinates into shared memory, transposed
// in chunks of V floats, and |k|^2 as an fmaf chain in index order.
template <int D>
__device__ __forceinline__ void stage_key(const float* __restrict__ src, int r, int kt, int d,
                                          float* sk, float* skn) {
  float s = 0.f;
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
#pragma unroll
    for (int j = 0; j < D; ++j) s = fmaf(v[j], v[j], s);
  } else {
    for (int j = 0; j < d; ++j) {
      const float v = src[j];
      sk[j * kt + r] = v;
      s = fmaf(v, v, s);
    }
  }
  skn[r] = s;
}

template <int D, int S>
__global__ void __launch_bounds__(THREADS, 2) pairwise_topk_kernel(
    const float* __restrict__ x, int n, int d_rt, int k, int kt,
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
#pragma unroll
      for (int j = 0; j < D; ++j) qn[r] = fmaf(q[r][j], q[r][j], qn[r]);
    }
  }
  if constexpr (D == 0) {
    float* qs = sq + warp * d;
    for (int j = lane; j < d; j += 32) qs[j] = live[0] ? x[(size_t)row[0] * d + j] : 0.f;
    __syncwarp();
    for (int j = 0; j < d; ++j) qn[0] = fmaf(qs[j], qs[j], qn[0]);
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
    for (int r = tid; r < rows; r += THREADS) stage_key<D>(x + (size_t)(k0 + r) * d, r, kt, d, sk, skn);
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
        unsigned long long v = e[r][0];
#pragma unroll
        for (int s = 1; s < S; ++s) v = s == kslot ? e[r][s] : v;
        v = __shfl_sync(FULL, v, klane);
        wd[r] = v == ~0ull ? FLT_MAX : __uint_as_float((unsigned)(v >> 32));
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

// The sliced instance, for any d: one row per warp, d streamed in slices of
// SLICE floats through shared memory (see the note at the top).
template <int S>
__global__ void __launch_bounds__(THREADS, 2) pairwise_topk_sliced_kernel(
    const float* __restrict__ x, int n, int d, int k,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int PER_LANE = TILE / 32;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                // (SLICE, TILE): the key tile's slice
  float* skn = sk + SLICE * TILE;  // (TILE,): |k|^2, carried over the slices
  float* sq = skn + TILE;          // (WARPS, SLICE): the warps' query slices

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x * WARPS + warp;
  const bool live = row < n;
  // |q|^2: every lane runs the same fmaf chain over the row (broadcast loads);
  // -0 + the first square is that square exactly
  float qn = -0.f;
  if (live)
    for (int j = 0; j < d; ++j) qn = fmaf(x[(size_t)row * d + j], x[(size_t)row * d + j], qn);

  unsigned long long e[S];
#pragma unroll
  for (int s = 0; s < S; ++s) e[s] = ~0ull;
  float wd = FLT_MAX;
  const int klane = (k - 1) / S, kslot = (k - 1) % S;

  for (int k0 = 0; k0 < n; k0 += TILE) {
    const int rows = min(TILE, n - k0);
    float acc[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] = -0.f;
    for (int s0 = 0; s0 < d; s0 += SLICE) {
      const int ds = min(SLICE, d - s0);
      __syncthreads();  // the previous slice (or tile) is consumed
      if (tid < rows) {
        const float* src = x + (size_t)(k0 + tid) * d + s0;
        float kn = s0 == 0 ? -0.f : skn[tid];
        for (int j = 0; j < ds; ++j) {
          const float v = src[j];
          sk[j * TILE + tid] = v;
          kn = fmaf(v, v, kn);
        }
        skn[tid] = kn;
      }
      for (int j = lane; j < ds; j += 32) sq[warp * SLICE + j] = live ? x[(size_t)row * d + s0 + j] : 0.f;
      __syncthreads();
      for (int j = 0; j < ds; ++j) {
        const float qj = sq[warp * SLICE + j];
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) acc[i] = fmaf(qj, sk[j * TILE + i * 32 + lane], acc[i]);
      }
    }
    // the tile's rounds: lane l takes key 32 i + l; the last slice's barrier
    // made every |k|^2 whole, and the next tile's first barrier keeps them
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int kr = i * 32 + lane;
      if (i * 32 >= rows) break;  // warp-uniform
      const float d2 = fmaxf(qn + skn[kr] - 2.f * acc[i], 0.f);
      const bool cand = d2 <= wd && live && kr < rows && k0 + kr != row;
      unsigned m = __ballot_sync(FULL, cand);
      if (m == 0u) continue;
      do {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const unsigned hi = __shfl_sync(FULL, __float_as_uint(d2), src);
        merge<S>(e, (unsigned long long)hi << 32 | (unsigned)(k0 + i * 32 + src), lane);
      } while (m != 0u);
      unsigned long long v = e[0];
#pragma unroll
      for (int s = 1; s < S; ++s) v = s == kslot ? e[s] : v;
      v = __shfl_sync(FULL, v, klane);
      wd = v == ~0ull ? FLT_MAX : __uint_as_float((unsigned)(v >> 32));
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = lane * S + s;
    if (p < k) {
      const unsigned long long v = e[s];
      out_d[(size_t)row * k + p] = v == ~0ull ? CUDART_INF_F : __uint_as_float((unsigned)(v >> 32));
      out_i[(size_t)row * k + p] = v == ~0ull ? -1 : (int)(unsigned)v;
    }
  }
}

template <int S>
int launch_sliced(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
                  int* occ) {
  const size_t smem = (size_t)(SLICE * TILE + TILE + WARPS * SLICE) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_topk_sliced_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (occ != nullptr) {
    occ[1] = THREADS, occ[2] = (int)smem, occ[3] = TILE;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, pairwise_topk_sliced_kernel<S>, THREADS, smem);
  }
  pairwise_topk_sliced_kernel<S><<<(n + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
      x, n, d, k, out_d, out_i);
  return (int)cudaGetLastError();
}

// Launches the <D, S> instance, or with `occ` set only reports its blocks per
// SM, threads per block, dynamic shared memory and key tile into occ[0..3].
template <int D, int S>
int launch(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
           int* occ) {
  constexpr int R = rows_per_warp<D, S>();
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
  const int rows_per_block = WARPS * R;
  pairwise_topk_kernel<D, S><<<(n + rows_per_block - 1) / rows_per_block, THREADS, smem, stream>>>(
      x, n, d, k, kt, out_d, out_i);
  return (int)cudaGetLastError();
}

// D = -1 is the sliced instance.
template <int D>
int launch_d(const float* x, int n, int d, int k, float* out_d, int* out_i, cudaStream_t stream,
             int* occ) {
#define REPRO_TOPK_S(S) \
  case S: return D < 0 ? launch_sliced<S>(x, n, d, k, out_d, out_i, stream, occ) \
                       : launch<(D < 0 ? 0 : D), S>(x, n, d, k, out_d, out_i, stream, occ);
  switch ((k + 31) / 32) {
    REPRO_TOPK_S(1) REPRO_TOPK_S(2) REPRO_TOPK_S(3) REPRO_TOPK_S(4)
    REPRO_TOPK_S(5) REPRO_TOPK_S(6) REPRO_TOPK_S(7) REPRO_TOPK_S(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_TOPK_S
}

int dispatch(const float* x, int n, int d, int k, float* out_d, int* out_i, void* stream,
             int* occ) {
  if (n < 2 || d < 1 || k < 1 || k > KMAX || k > n - 1 || reinterpret_cast<size_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d > MAX_D_TILED) return launch_d<-1>(x, n, d, k, out_d, out_i, s, occ);
  switch (d) {
    case 2: return launch_d<2>(x, n, d, k, out_d, out_i, s, occ);
    case 4: return launch_d<4>(x, n, d, k, out_d, out_i, s, occ);
    case 8: return launch_d<8>(x, n, d, k, out_d, out_i, s, occ);
    case 16: return launch_d<16>(x, n, d, k, out_d, out_i, s, occ);
    case 32: return launch_d<32>(x, n, d, k, out_d, out_i, s, occ);
    default: return launch_d<0>(x, n, d, k, out_d, out_i, s, occ);
  }
}

}  // namespace

// x: (n, d) float32 row-major, 16-byte aligned; out_d: (n, k) float32;
// out_i: (n, k) int32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_pairwise_topk(const float* x, int n, int d, int k,
                                   float* out_d, int* out_i, void* stream) {
  return dispatch(x, n, d, k, out_d, out_i, stream, nullptr);
}

// The launch configuration the kernel takes for (n, d, k), without launching:
// occ = {blocks per SM, threads per block, dynamic shared memory bytes, key tile}.
extern "C" int repro_pairwise_topk_occupancy(int n, int d, int k, int* occ) {
  return dispatch(nullptr, n, d, k, nullptr, nullptr, nullptr, occ);
}
