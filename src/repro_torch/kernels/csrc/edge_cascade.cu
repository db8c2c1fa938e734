// edge_cascade.cu — the fused per-edge filter cascade of the RNG build.
//
// Replaces the TPU kernel repro/kernels/fused_cascade.py::_edge_cascade_kernel
// (Pallas; dispatch `_edge_cascade_pallas`, called through `edge_cascade` from
// repro/core/rng.py::_build_fused, stage 1 with k_check = 2 and stage 2 with
// k_check = kmax - 1; the slot path calls it unstaged, on unsorted edges).
//
// Per edge (a, b), as the reference computes it:
//   d2   = |x_a - x_b|^2 in diff form;
//   w2   = max(cd2_a, cd2_b, d2);
//   cert = (w2 == max(cd2_a, cd2_b)), bit-exact by construction;
//   kill = some c among the first k_check stored neighbours of a or b, c not
//          an endpoint, lies strictly inside the lune:
//            max(mrd_own, mrd_oth) < w2, where
//            mrd_own = max(knn_d2[own][j], cd2_own, cd2_c) + eps*(|x_own|^2 + |x_c|^2),
//            mrd_oth = max(|x_oth - x_c|^2, cd2_oth, cd2_c) + eps*(|x_oth|^2 + |x_c|^2),
//          eps = 64 * 2^-23.
//
// What bounds it on the H100: bytes, as sectors.  The edge list streams in
// once (about 25 bytes an edge), but every check gathers from scattered
// points: a table entry, and for a check that can still fire the neighbour's
// coordinates.  The points and the tables (n * (8 + 8 k_check) bytes) stay
// in L2, so the limit is L2 sectors touched and the latency of dependent
// gathers, not arithmetic.
//
// Design.
//   * A prologue kernel, one thread per (point p, slot j), writes
//     pn[p] = (|x_p|^2, cd2k[p]) and tab[p][j] = (mrd_own, c): the half of
//     a check that depends on the point and the slot only, computed once
//     instead of once per edge.
//   * The per-edge kernel splits the test: for finite inputs
//     max(mrd_own, mrd_oth) < w2 is mrd_own < w2 && mrd_oth < w2.  A check
//     reads its 8-byte table entry first and gathers x_c only when the own
//     half passes and c is not an endpoint.  The verdict is an OR, so a check
//     skipped because it cannot fire changes no bit.
//   * A certified edge is never killed: mrd_own >= cd2_own and mrd_oth >=
//     cd2_oth (the margin is a product of eps and a sum of squares, never
//     negative), so max(mrd_own, mrd_oth) >= max(cd2_a, cd2_b) = w2.  It
//     skips the checks.
//   * G lanes per edge (a template parameter, 1 to 32): the group splits the
//     2 k_check (side, slot) checks, a round of G at a time, votes after
//     each round (__ballot_sync over the group's lanes) and stops at the
//     first hit.  Every lane repeats the edge's own gathers and d2, so the
//     wrapper gives a lane up to 16 checks (G = 1 at k_check = 2, 2 at 15,
//     8 at 63) rather than one.  The a side comes first: on sorted input
//     (stage 1's packed keys) consecutive edges share a, so its table row
//     and its neighbours' coordinates are broadcasts within the warp.
//   * Widths d in {2, 4, 8, 16, 32} are templates: rows in registers, read
//     as float4 (float2 at d = 2).  Any other d takes the generic path, with
//     no bound on d.
//   * Bool outputs are written as bytes straight into torch.bool tensors.
//
// Every sum of squares runs in one of three orders (`order`), the same in
// the prologue and the per-edge kernel: 0 index order unfused
// (__fmul_rn/__fadd_rn, never contracted), 1 index order as an fmaf chain,
// 2 XLA's windows of 32 (at d <= 32 one window: order 0; above 32 x 32,
// windows of windows: tree_sum).  d2, w2 and the
// verdicts equal the plain PyTorch version bit for bit in each.

#include <cuda_runtime.h>

#include "xla_order.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float kEps = 7.62939453125e-06f;  // 64 * 2^-23
constexpr int kSeq = 0, kFma = 1, kWin32 = 2;
constexpr int kPrologueThreads = 256;
constexpr int kMaxThreads = 256;  // per-edge kernel: the launch bound below assumes it

struct __align__(8) OwnEntry {
  float mrd;  // mrd_own of (p, slot j)
  int c;      // knn_idx[p][j]
};

// acc + t * t, unfused or with one rounding; the first term of a sum is
// the rounded square in every order.
__device__ __forceinline__ float add_sq(float acc, float t, bool fma) {
  return fma ? fmaf(t, t, acc) : __fadd_rn(acc, __fmul_rn(t, t));
}

// |p - q|^2, or |p|^2 when q is null, over a runtime width in `order`.
__device__ float sum_sq_rt(const float* __restrict__ p, const float* __restrict__ q, int d,
                           int order) {
  auto term = [&](int j) { return q ? __fsub_rn(__ldg(p + j), __ldg(q + j)) : __ldg(p + j); };
  if (order == kWin32 && d > 32 * 32) {
    return tree_sum([&](int j) { const float t = term(j); return __fmul_rn(t, t); }, d);
  }
  if (order == kWin32) {
    // W windows of 32 over the row padded by (32 W - d) / 2 zeros in front:
    // each window sums its real elements in index order, then the window
    // sums are added in order.
    const int nw = (d + 31) / 32, pad_lo = (32 * nw - d) / 2;
    float total = 0.f;
    for (int w = 0; w < nw; ++w) {
      const int s0 = max(0, 32 * w - pad_lo), s1 = min(d, 32 * w + 32 - pad_lo);
      float t = term(s0);
      float acc = __fmul_rn(t, t);
      for (int j = s0 + 1; j < s1; ++j) {
        t = term(j);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
      total = w ? __fadd_rn(total, acc) : acc;
    }
    return total;
  }
  const bool fma = order == kFma;
  const float t0 = term(0);
  float acc = __fmul_rn(t0, t0);
  for (int j = 1; j < d; ++j) acc = add_sq(acc, term(j), fma);
  return acc;
}

// One point row into registers: float4 loads where D % 4 == 0, else float2.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src) + c);
      v[4 * c] = t.x, v[4 * c + 1] = t.y, v[4 * c + 2] = t.z, v[4 * c + 3] = t.w;
    }
  } else {
    static_assert(D % 2 == 0, "templated widths are even");
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(src) + c);
      v[2 * c] = t.x, v[2 * c + 1] = t.y;
    }
  }
}

// Sums over registers, d <= 32: one window, so win32 is the unfused order.
template <int D>
__device__ __forceinline__ float norm_reg(const float (&v)[D], bool fma) {
  float acc = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) acc = add_sq(acc, v[j], fma);
  return acc;
}

template <int D>
__device__ __forceinline__ float dist_reg(const float (&p)[D], const float (&q)[D], bool fma) {
  const float t0 = __fsub_rn(p[0], q[0]);
  float acc = __fmul_rn(t0, t0);
#pragma unroll
  for (int j = 1; j < D; ++j) acc = add_sq(acc, __fsub_rn(p[j], q[j]), fma);
  return acc;
}

template <int D>
__device__ __forceinline__ float point_norm(const float* __restrict__ x, int p, int d, int order) {
  if constexpr (D > 0) {
    float v[D];
    load_row<D>(x + (size_t)p * D, v);
    return norm_reg<D>(v, order == kFma);
  } else {
    return sum_sq_rt(x + (size_t)p * d, nullptr, d, order);
  }
}

// One thread per (point p, slot j < max(k_check, 1)).
template <int D>
__global__ void __launch_bounds__(kPrologueThreads) edge_cascade_prologue(
    const float* __restrict__ x, const float* __restrict__ cd2k,
    const int* __restrict__ knn_idx, const float* __restrict__ knn_d2, int n, int d_rt,
    int k_full, int k_check, int order, float2* __restrict__ pn, OwnEntry* __restrict__ tab) {
  const int d = D > 0 ? D : d_rt;
  const int slots = k_check > 0 ? k_check : 1;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n * slots) return;
  const int p = (int)(t / slots), j = (int)(t % slots);
  const float np = point_norm<D>(x, p, d, order);
  const float cdp = __ldg(cd2k + p);
  if (j == 0) pn[p] = make_float2(np, cdp);
  if (j < k_check) {
    const size_t at = (size_t)p * k_full + j;
    const int c = __ldg(knn_idx + at);
    const float nc = point_norm<D>(x, c, d, order);
    OwnEntry en;
    en.mrd = __fadd_rn(fmaxf(fmaxf(__ldg(knn_d2 + at), cdp), __ldg(cd2k + c)),
                       __fmul_rn(kEps, __fadd_rn(np, nc)));
    en.c = c;
    tab[(size_t)p * k_check + j] = en;
  }
}

// G lanes per edge; a group never straddles a warp (blockDim.x % 32 == 0).
// At d <= 8 the launch bound holds a thread to 40 registers, six blocks of
// 256 threads per SM: more edges in flight to hide the dependent gathers.
template <int D, int G>
__global__ void __launch_bounds__(kMaxThreads, D > 0 && D <= 8 ? 6 : 1) edge_cascade_kernel(
    const float* __restrict__ x, const float2* __restrict__ pn,
    const OwnEntry* __restrict__ tab, int d_rt, const int* __restrict__ ea,
    const int* __restrict__ eb, const unsigned char* __restrict__ valid, int m, int k_check,
    int order, unsigned char* __restrict__ killed, unsigned char* __restrict__ cert,
    float* __restrict__ d2_out, float* __restrict__ w2_out) {
  constexpr int DR = D > 0 ? D : 1;  // register extent of a row
  const int d = D > 0 ? D : d_rt;
  const long long e_ll = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / G;
  if (e_ll >= m) return;  // whole groups: every lane of a group has the same edge
  const int e = (int)e_ll;
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1u) << (lane - sub);
  const bool fma = order == kFma;

  const bool v = valid[e] != 0;
  const int a = v ? __ldg(ea + e) : 0;  // invalid slots read point 0; masked below
  const int b = v ? __ldg(eb + e) : 0;
  const float2 pa = __ldg(pn + a), pb = __ldg(pn + b);  // (|x|^2, cd2)
  float xa[DR], xb[DR];
  float d2;
  if constexpr (D > 0) {
    load_row<D>(x + (size_t)a * D, xa);
    load_row<D>(x + (size_t)b * D, xb);
    d2 = dist_reg<D>(xa, xb, fma);
  } else {
    d2 = sum_sq_rt(x + (size_t)a * d, x + (size_t)b * d, d, order);
  }
  const float mcd = fmaxf(pa.y, pb.y);
  const float w2 = fmaxf(mcd, d2);
  const bool is_cert = w2 == mcd;

  bool kill = false;
  if (v && !is_cert) {  // group-uniform
    const int n_checks = 2 * k_check;
    for (int r = 0; r < n_checks; r += G) {
      const int t = r + sub;
      bool hit = false;
      if (t < n_checks) {
        const int side = t >= k_check;  // 0: own = a, other = b; 1: own = b, other = a
        const int j = side ? t - k_check : t;
        const OwnEntry en = tab[(size_t)(side ? b : a) * k_check + j];
        if (en.mrd < w2 && en.c != a && en.c != b) {
          const float2 pc = __ldg(pn + en.c);
          const float2 po = side ? pa : pb;
          float d2o;
          if constexpr (D > 0) {
            float xc[D], xo[D];
            load_row<D>(x + (size_t)en.c * D, xc);
#pragma unroll
            for (int q = 0; q < D; ++q) xo[q] = side ? xa[q] : xb[q];
            d2o = dist_reg<D>(xo, xc, fma);
          } else {
            d2o = sum_sq_rt(x + (size_t)(side ? a : b) * d, x + (size_t)en.c * d, d, order);
          }
          const float mrd_oth = __fadd_rn(fmaxf(fmaxf(d2o, po.y), pc.y),
                                          __fmul_rn(kEps, __fadd_rn(po.x, pc.x)));
          hit = mrd_oth < w2;
        }
      }
      if (__ballot_sync(gmask, hit)) {
        kill = true;
        break;
      }
    }
  }
  if (sub == 0) {
    killed[e] = kill ? 1 : 0;
    cert[e] = (v && is_cert) ? 1 : 0;
    d2_out[e] = d2;
    w2_out[e] = w2;
  }
}

struct Args {
  const float* x;
  const float* cd2k;
  const int* knn_idx;
  const float* knn_d2;
  int n, d, k_full;
  const int* ea;
  const int* eb;
  const unsigned char* valid;
  int m, k_check, order, block;
  float2* pn;
  OwnEntry* tab;
  unsigned char* killed;
  unsigned char* cert;
  float* d2_out;
  float* w2_out;
  cudaStream_t stream;
};

// Launches the prologue and the <D, G> per-edge kernel, or with `occ` set
// only reports {blocks per SM, threads} of the per-edge kernel and of the
// prologue into occ[0..3].
template <int D, int G>
int run(const Args& A, int* occ) {
  if (occ != nullptr) {
    occ[1] = A.block, occ[3] = kPrologueThreads;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, edge_cascade_kernel<D, G>, A.block, 0);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ + 2, edge_cascade_prologue<D>, kPrologueThreads, 0);
  }
  const long long slots = A.k_check > 0 ? A.k_check : 1;
  const long long pro_threads = (long long)A.n * slots;
  edge_cascade_prologue<D><<<(unsigned)((pro_threads + kPrologueThreads - 1) / kPrologueThreads),
                             kPrologueThreads, 0, A.stream>>>(
      A.x, A.cd2k, A.knn_idx, A.knn_d2, A.n, A.d, A.k_full, A.k_check, A.order, A.pn, A.tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)A.m * G;
  edge_cascade_kernel<D, G><<<(unsigned)((threads + A.block - 1) / A.block), A.block, 0, A.stream>>>(
      A.x, A.pn, A.tab, A.d, A.ea, A.eb, A.valid, A.m, A.k_check, A.order, A.killed, A.cert,
      A.d2_out, A.w2_out);
  return (int)cudaGetLastError();
}

template <int D>
int run_lanes(const Args& A, int lanes, int* occ) {
  switch (lanes) {
    case 1: return run<D, 1>(A, occ);
    case 2: return run<D, 2>(A, occ);
    case 4: return run<D, 4>(A, occ);
    case 8: return run<D, 8>(A, occ);
    case 16: return run<D, 16>(A, occ);
    case 32: return run<D, 32>(A, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& A, int lanes, int* occ) {
  if (A.m < 1 || A.n < 1 || A.d < 1 || A.k_check < 0 || A.k_check > A.k_full || A.order < 0 ||
      A.order > 2 || A.block < 32 || A.block > kMaxThreads || A.block % 32 != 0 ||
      reinterpret_cast<size_t>(A.x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (A.d) {
    case 2: return run_lanes<2>(A, lanes, occ);
    case 4: return run_lanes<4>(A, lanes, occ);
    case 8: return run_lanes<8>(A, lanes, occ);
    case 16: return run_lanes<16>(A, lanes, occ);
    case 32: return run_lanes<32>(A, lanes, occ);
    default: return run_lanes<0>(A, lanes, occ);
  }
}

}  // namespace

// x: (n, d) f32, 16-byte aligned; cd2k: (n,) f32; knn_idx: (n, k_full) i32;
// knn_d2: (n, k_full) f32; ea, eb: (m,) i32; valid: (m,) bool; order: 0
// unfused, 1 fmaf chain, 2 windows of 32; lanes per edge in {1, 2, 4, 8, 16,
// 32}; block: threads per block, a multiple of 32 up to 256.  Scratch written by the
// prologue: pn (n, 2) f32 and tab (n, max(k_check, 1)) 8-byte entries.
// Outputs: killed, cert (m,) bool; d2, w2 (m,) f32.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int repro_edge_cascade(
    const float* x, const float* cd2k, const int* knn_idx, const float* knn_d2, int n, int d,
    int k_full, const int* ea, const int* eb, const unsigned char* valid, int m, int k_check,
    int order, int lanes, int block, void* pn, void* tab, unsigned char* killed,
    unsigned char* cert, float* d2_out, float* w2_out, void* stream) {
  const Args A{x, cd2k, knn_idx, knn_d2, n, d, k_full, ea, eb, valid, m, k_check, order, block,
               static_cast<float2*>(pn), static_cast<OwnEntry*>(tab), killed, cert, d2_out,
               w2_out, (cudaStream_t)stream};
  return dispatch(A, lanes, nullptr);
}

// The launch configuration for (d, lanes, block) without launching: occ =
// {per-edge kernel blocks per SM, its threads per block, prologue blocks per
// SM, its threads per block}.
extern "C" int repro_edge_cascade_occupancy(int d, int lanes, int block, int* occ) {
  const Args A{nullptr, nullptr, nullptr, nullptr, 1, d, 1, nullptr, nullptr, nullptr, 1, 1, 0,
               block, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return dispatch(A, lanes, occ);
}
