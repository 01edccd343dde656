// Helpers shared by the port's CUDA kernels: loads and stores that
// compute in fp32 whatever the tensor's type, and a launch that opts a
// kernel in to more than 48 KB of dynamic shared memory, once a kernel;
// bf16 packing, mma.sync and ldmatrix for the kernels that use them.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Two floats rounded to nearest bf16 and packed low, high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mma.sync m16n8k16, bf16 in, fp32 accumulate. Fragments (PTX ISA), lane
// = 4 g + t:
//   A (16 x 16): {row g, cols 2t..2t+1}, {row g+8, same}, {row g, cols
//                2t+8..2t+9}, {row g+8, same}
//   B (16 x 8):  {rows 2t..2t+1, col g}, {rows 2t+8..2t+9, col g}
//   C (16 x 8):  row g cols 2t, 2t+1; row g+8 cols 2t, 2t+1
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8 m .. 8 m + 7 give
// the row addresses of matrix m, and lane 4 g + t receives row g, columns
// 2t and 2t + 1 of each (of its transpose with the _trans form).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
