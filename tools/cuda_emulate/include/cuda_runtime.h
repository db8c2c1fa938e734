// cuda_runtime.h for the CPU emulation (cuda_stub_core.h): the runtime calls
// the emulated kernels make; a cluster launch runs the kernel at once.
#pragma once
#include "cuda_stub_core.h"

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchTimeout = 6, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributeNonPortableClusterSizeAllowed };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return stub_take_timeout(); }

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...), A&&... a) {
  stub_run(k, cfg->gridDim.x, cfg->blockDim.x, cfg->dynamicSmemBytes, cfg->attrs[0].val.clusterDim.x, P(a)...);
  return stub_take_timeout();
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}

// two SMs of one block each: the persistent grids stay small
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t bytes, cudaStream_t = nullptr) {
  std::memset(p, v, bytes);
  return cudaSuccess;
}
