// single_linkage.cu — batched single-linkage dendrograms: R union-find loops,
// one per hierarchy row.
//
// Ports the device loop of repro/core/linkage.py::_single_linkage_one
// (vmapped over the R rows by single_linkage_batch, stage 1 of extraction).
// The reference runs it as a jax.lax.fori_loop over the n-1 weight-sorted MST
// edges, outside any Pallas kernel.  Merge i of a row, for its sorted edge
// (a, b):
//   ra = find(a), rb = find(b)            read-only walks, no path compression
//   left[i] = label[ra], right[i] = label[rb], size[i] = csize[ra] + csize[rb]
//   union by size: csize[ra] >= csize[rb] keeps ra as the root (the winner)
//   parent[loser] = winner, label[winner] = n + i, csize[winner] = size[i]
// The sort by (weight, edge id) stays outside, as in the reference: the
// wrapper hands this kernel each row's endpoints in merge order.
//
// What bounds it on the H100: latency.  A row's merges form one dependent
// chain (each find reads what the previous merges wrote), a handful of
// dependent loads a merge; the bytes (8 in and 12 out a merge) and the
// operations are negligible.  Rows are independent.
//
// Design.  One thread block per row; one thread (lane 0 of warp 0) walks the
// row's merges in order and touches only shared memory:
//   - the other warps stage the merges into shared memory in chunks of
//     CHUNK, a chunk ahead of the walker (double-buffered): each loads a
//     merge's sorted endpoints from device memory in coalesced loads and
//     stages, for each, the root it reaches in the forest as it stands then
//     (a read-only walk).  The walker starts each find there, so most of a
//     find's hops are taken off its chain.  The stagers also copy the
//     walker's left/right/size chunks to device memory in coalesced stores.
//     Walker and stagers meet at one block barrier a chunk;
//   - the state is packed into one 64-bit word a vertex: its parent, or, at
//     a root, the sign bit, the component's label (bits 32-62) and its size
//     (bits 0-31).  8 bytes a vertex: in shared memory up to smem_max_n()
//     vertices (26368), in a device-memory scratch of the wrapper's above
//     that (or when the caller forces that layout);
//   - the two finds of a merge walk side by side (their loads issue
//     together) with path halving: each step of a walk points the vertex at
//     its grandparent.  A find ends on a negative word, the root's, which
//     holds the label and size that the merge reads, so the merge needs no
//     load beyond the walks; the next merge's staged roots are loaded
//     before this merge's stores.
// Why the outputs stay equal to the reference's: the forest changes only by
// linking a root under another root (a union) and by path halving, which
// re-points a non-root vertex at one of its ancestors; neither moves a
// vertex to another component, and halving changes no root and no root's
// word.  So a walk from any vertex that was ever on a's path to its root,
// a stale root that a stager staged included, ends at a's current root,
// and reads its label and size.  A merge's left, right and size depend on
// the two roots, their labels and their sizes alone, and union by size
// picks the winner from those alone; by induction over the merges every
// root, size and label, and so every output, equals the read-only walk's.
// The stagers' walks race with the walker's stores: every 8-byte word a
// stager reads is one the walker wrote whole, and any word on the path
// leads to the same root, so whatever root a stager stages is one the
// walker's find can start from.  The outputs are integers, so they equal
// the plain PyTorch version's exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;               // warp 0 walks, warps 1-7 stage
constexpr int CHUNK = 512;                 // merges a staged chunk
constexpr int SMEM_DEFAULT = 48 * 1024;    // above this, dynamic smem needs an opt-in
constexpr int SMEM_MAX = 227 * 1024 - 1024;  // of the 227 KB a block may have
constexpr int STAGE_BYTES = 2 * 5 * CHUNK * (int)sizeof(int);  // (a, b) roots in, (left, right, size) out, twice

constexpr long long ROOT = (long long)(1ull << 63);

__device__ __forceinline__ long long root_word(int label, int size) {
  return ROOT | ((long long)label << 32) | (unsigned)size;
}

// One step of a find at v, whose word p >= 0 is its parent: path halving.
// Returns the next vertex and sets p to its word (negative: a root).
__device__ __forceinline__ int halve(long long* state, int v, long long& p) {
  const int pv = (int)p;
  const long long g = state[pv];
  if (g < 0) {  // pv is the root
    p = g;
    return pv;
  }
  state[v] = g;
  p = state[(int)g];
  return (int)g;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) single_linkage_kernel(
    const int* __restrict__ ea_s, const int* __restrict__ eb_s, int n, int* __restrict__ scratch,
    int* __restrict__ left, int* __restrict__ right, int* __restrict__ size) {
  extern __shared__ __align__(16) int smem[];
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int m = n - 1;
  const int n_chunks = (m + CHUNK - 1) / CHUNK;
  int* stage_in = smem;                       // [2][2][CHUNK]: a, b
  int* stage_out = stage_in + 4 * CHUNK;      // [2][3][CHUNK]: left, right, size
  long long* state = SMEM ? reinterpret_cast<long long*>(stage_out + 6 * CHUNK)
                          : reinterpret_cast<long long*>(scratch) + (size_t)row * n;
  const int* a_g = ea_s + (size_t)row * m;
  const int* b_g = eb_s + (size_t)row * m;
  int* out_g[3] = {left + (size_t)row * m, right + (size_t)row * m, size + (size_t)row * m};

  // chunk c's merges into stage buffer c & 1, by threads [t0, t0 + nt): for
  // each endpoint the root it reaches now
  auto stage = [&](int c, int t0, int nt) {
    const int base = c * CHUNK, len = min(CHUNK, m - base);
    int* dst = stage_in + (c & 1) * 2 * CHUNK;
    const volatile long long* vs = state;
    for (int j = tid - t0; j < len; j += nt) {
      int ends[2] = {a_g[base + j], b_g[base + j]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        long long w = vs[ends[e]];
        while (w >= 0) {
          ends[e] = (int)w;
          w = vs[ends[e]];
        }
        dst[e * CHUNK + j] = ends[e];
      }
    }
  };
  // chunk c's outputs from stage buffer c & 1 to device memory
  auto drain = [&](int c, int t0, int nt) {
    const int base = c * CHUNK, len = min(CHUNK, m - base);
    const int* srcb = stage_out + (c & 1) * 3 * CHUNK;
    for (int j = tid - t0; j < len; j += nt) {
#pragma unroll
      for (int f = 0; f < 3; ++f) out_g[f][base + j] = srcb[f * CHUNK + j];
    }
  };

  for (int v = tid; v < n; v += THREADS) state[v] = root_word(v, 1);
  __syncthreads();
  stage(0, 0, THREADS);
  __syncthreads();

  int a = 0, b = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * CHUNK, len = min(CHUNK, m - base);
    if (warp == 0) {
      if (tid == 0) {
        const int* sa = stage_in + (c & 1) * 2 * CHUNK;  // the staged roots
        int* so = stage_out + (c & 1) * 3 * CHUNK;
        a = sa[0];
        b = sa[CHUNK];
        for (int j = 0; j < len; ++j) {
          int va = a, vb = b;
          long long pa = state[va], pb = state[vb];
          if (j + 1 < len) a = sa[j + 1], b = sa[CHUNK + j + 1];  // the next merge's
          while (pa >= 0 || pb >= 0) {
            if (pa >= 0) va = halve(state, va, pa);
            if (pb >= 0) vb = halve(state, vb, pb);
          }
          // va, vb are the roots, pa, pb their words
          const int sa_ = (int)(unsigned)pa, sb_ = (int)(unsigned)pb, tot = sa_ + sb_;
          so[j] = (int)((pa >> 32) & 0x7fffffff);
          so[CHUNK + j] = (int)((pb >> 32) & 0x7fffffff);
          so[2 * CHUNK + j] = tot;
          const int winner = sa_ >= sb_ ? va : vb;
          state[sa_ >= sb_ ? vb : va] = winner;
          state[winner] = root_word(n + base + j, tot);
        }
      }
      __syncwarp();
    } else {
      if (c + 1 < n_chunks) stage(c + 1, 32, THREADS - 32);
      if (c > 0) drain(c - 1, 32, THREADS - 32);
    }
    __syncthreads();
  }
  if (n_chunks > 0) drain(n_chunks - 1, 0, THREADS);
}

}  // namespace

// The largest n whose state the kernel keeps in shared memory.
extern "C" int repro_single_linkage_smem_max_n() { return (SMEM_MAX - STAGE_BYTES) / (2 * (int)sizeof(int)); }

// ea_s, eb_s: (R, n-1) i32, each row's MST endpoints in merge order (sorted
// by weight, stable in edge id); left, right, size: (R, n-1) i32 outputs.
// The state lives in shared memory when `shared` is set (n <= 26368) and in
// `scratch` otherwise: (R, n) 64-bit words, 8-byte aligned, needed only then
// (else null).  Returns
// the cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a
// layout that does not fit.
extern "C" int repro_single_linkage(const int* ea_s, const int* eb_s, int R, int n, int shared, int* scratch,
                                    int* left, int* right, int* size, void* stream) {
  if (R < 1 || n < 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!shared) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (STAGE_BYTES > SMEM_DEFAULT) {
      const cudaError_t err = cudaFuncSetAttribute(
          single_linkage_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
      if (err != cudaSuccess) return (int)err;
    }
    single_linkage_kernel<false><<<R, THREADS, STAGE_BYTES, s>>>(ea_s, eb_s, n, scratch, left, right, size);
    return (int)cudaGetLastError();
  }
  if (n > repro_single_linkage_smem_max_n()) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)STAGE_BYTES + (size_t)2 * n * sizeof(int);
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        single_linkage_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  single_linkage_kernel<true><<<R, THREADS, smem, s>>>(ea_s, eb_s, n, nullptr, left, right, size);
  return (int)cudaGetLastError();
}
