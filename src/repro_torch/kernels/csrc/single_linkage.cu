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
// dependent loads a merge (union by size keeps every walk within log2 n
// steps); the bytes (8 in and 12 out a merge) and the operations are
// negligible.  Rows are independent.
//
// Design.  One thread block per row; its threads initialise the row's state,
// then one thread walks the n-1 merges.  The state (parent, label, csize) is
// 12 bytes a vertex: in shared memory up to SMEM_MAX / 12 vertices (19114),
// in a device-memory scratch of the wrapper's above that (L2-resident: 4.3 MB
// for R = 15 at n = 24000).  The outputs are integers, so they equal the
// plain PyTorch version's and the reference's exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, dynamic smem needs an opt-in
constexpr int SMEM_MAX = 224 * 1024;     // of the 227 KB a block may have

__device__ __forceinline__ int find(const int* parent, int v) {
  int p = parent[v];
  while (p != v) {
    v = p;
    p = parent[v];
  }
  return v;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) single_linkage_kernel(
    const int* __restrict__ ea_s, const int* __restrict__ eb_s, int n, int* __restrict__ scratch,
    int* __restrict__ left, int* __restrict__ right, int* __restrict__ size) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const size_t m = (size_t)(n - 1);
  int* parent = SMEM ? smem : scratch + (size_t)row * 3 * n;
  int* label = parent + n;
  int* csize = label + n;
  for (int v = threadIdx.x; v < n; v += blockDim.x) parent[v] = v, label[v] = v, csize[v] = 1;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* a = ea_s + row * m;
  const int* b = eb_s + row * m;
  int* lo = left + row * m;
  int* hi = right + row * m;
  int* sz = size + row * m;
  for (int i = 0; i < n - 1; ++i) {
    const int ra = find(parent, a[i]);
    const int rb = find(parent, b[i]);
    const int sa = csize[ra], sb = csize[rb];
    lo[i] = label[ra];
    hi[i] = label[rb];
    sz[i] = sa + sb;
    const int winner = sa >= sb ? ra : rb;
    parent[sa >= sb ? rb : ra] = winner;
    label[winner] = n + i;
    csize[winner] = sa + sb;
  }
}

}  // namespace

// The largest n whose state the kernel keeps in shared memory.
extern "C" int repro_single_linkage_smem_max_n() { return SMEM_MAX / (3 * (int)sizeof(int)); }

// ea_s, eb_s: (R, n-1) i32, each row's MST endpoints in merge order (sorted
// by weight, stable in edge id); left, right, size: (R, n-1) i32 outputs.
// The state lives in shared memory when n <= 19114 and in `scratch` above:
// (R, 3, n) i32, needed only then (else null).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int repro_single_linkage(const int* ea_s, const int* eb_s, int R, int n, int* scratch,
                                    int* left, int* right, int* size, void* stream) {
  if (R < 1 || n < 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool global = n > repro_single_linkage_smem_max_n();
  if (global) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    single_linkage_kernel<false><<<R, THREADS, 0, s>>>(ea_s, eb_s, n, scratch, left, right, size);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)3 * n * sizeof(int);
  if (smem > (size_t)SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        single_linkage_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  single_linkage_kernel<true><<<R, THREADS, smem, s>>>(ea_s, eb_s, n, nullptr, left, right, size);
  return (int)cudaGetLastError();
}
