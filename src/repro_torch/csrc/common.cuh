// Helpers shared by the port's CUDA kernels: loads and stores that
// compute in fp32 whatever the tensor's type, and a launch that opts a
// kernel in to more than 48 KB of dynamic shared memory, once a kernel.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Launches Kernel(p) on grid x threads with `bytes` of dynamic shared
// memory; the first call for each Kernel raises its limit to max_bytes.
// Returns the launch's CUDA error (cudaSuccess on success).
template <auto Kernel, typename P>
cudaError_t launch_opt_in(dim3 grid, int threads, size_t max_bytes,
                          size_t bytes, const P& p, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
  if (set != cudaSuccess) return set;
  Kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}
