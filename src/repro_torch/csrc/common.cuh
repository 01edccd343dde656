// Helpers shared by the port's CUDA kernels: loads and stores that
// compute in fp32 whatever the tensor's type, and a launch that opts a
// kernel in to more than 48 KB of dynamic shared memory, once a kernel;
// bf16 packing, mma.sync and ldmatrix for the kernels that use them; and
// the scans' tensor-core toolkit (ssd_scan.cu, wkv_scan.cu): fp32 factors
// split into bf16 terms, a tile loader that keeps its 16-byte loads in
// flight, ldmatrix lane addresses, term-by-term products and a
// scattered warp reduction; and, in namespace wkv, what the wkv scan and
// its backward share (per-channel step loads, cumsums in double).
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

// ---- The scans' tensor-core toolkit ----

// Row stride, in bf16 elements, of a staged tile of 64 columns: 64 + 8
// against ldmatrix bank conflicts.
constexpr int TILE_LD = 72;

// Terms of an operand: an exact bf16 input is one term, an fp32 one three.
template <typename T>
__host__ __device__ constexpr int terms() { return sizeof(T) == 2 ? 1 : 3; }

// lo and hi split into K bf16 terms each, packed low, high: term k holds
// what terms 0..k-1 left over, rounded to nearest (each residual is exact
// in fp32), so the K terms sum to the value within 2^-(8 K) relative.
template <int K>
__device__ __forceinline__ void split_pack(float lo, float hi,
                                           uint32_t (&r)[3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r[k] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

// 16 bytes of bf16 or fp32 as floats.
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __low2float(b[k]);
    f[2 * k + 1] = __high2float(b[k]);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// A ROWS x 64 tile, rows [0, n) x cols [0, m) of `src` (element (i, j) at
// i * rs + j) and zeros elsewhere, as floats, loaded by a block of NT
// threads: thread `tid` holds the V = 16 / sizeof(T) elements from (tid +
// k NT) V on in v[k], and issues all its 16-byte loads before it uses any
// (a ragged or unaligned run is loaded element by element).
template <int ROWS, typename T, int NT = 256>
struct Tile {
  static constexpr int V = 16 / sizeof(T), PER = ROWS * 64 / V / NT;
  float v[PER][V];
  __device__ __forceinline__ Tile(const T* __restrict__ src, size_t rs,
                                  int n, int m) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = (threadIdx.x + k * NT) * V, i = idx / 64, j = idx % 64;
      const T* ptr = src + (size_t)i * rs + j;
      if (i < n && j + V <= m && (reinterpret_cast<uintptr_t>(ptr) & 15) == 0) {
        unpack(__ldg(reinterpret_cast<const uint4*>(ptr)), v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[k][e] = (i < n && j + e < m) ? load(ptr, e) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ static int row(int k) {
    return (threadIdx.x + k * NT) * V / 64;
  }
  __device__ __forceinline__ static int col(int k) {
    return (threadIdx.x + k * NT) * V % 64;
  }
  // The tile as floats, dst[i * ld + j] (T = float, ld a multiple of 4,
  // dst 16-byte aligned).
  __device__ __forceinline__ void store_f32(float* dst, int ld) const {
    static_assert(V == 4, "store_f32 stores fp32 tiles");
#pragma unroll
    for (int k = 0; k < PER; ++k)
      *reinterpret_cast<float4*>(dst + row(k) * ld + col(k)) =
          make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
  }
  // The tile as K-term bf16 tiles dst[t][i * TILE_LD + j]; consumes v.
  template <int K>
  __device__ __forceinline__ void store_terms(__nv_bfloat16* dst) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      __nv_bfloat16* d = dst + row(k) * TILE_LD + col(k);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        uint32_t w[V / 2];
#pragma unroll
        for (int e = 0; e < V / 2; ++e) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(v[k][2 * e],
                                                         v[k][2 * e + 1]);
          w[e] = *reinterpret_cast<const uint32_t*>(&b);
          v[k][2 * e] -= __low2float(b);
          v[k][2 * e + 1] -= __high2float(b);
        }
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(d + t * ROWS * TILE_LD) =
              make_uint4(w[0], w[1], w[2], w[3]);
        else
          *reinterpret_cast<uint2*>(d + t * ROWS * TILE_LD) =
              make_uint2(w[0], w[1]);
      }
    }
  }
};

// ldmatrix lane addresses (element offsets in a TILE_LD-strided tile): the
// A fragment of rows r0..r0+15, cols c0..c0+15; two n8 B fragments whose
// n runs along rows n0..n0+15 and k along cols c0..c0+15 (B^T stored
// row-major); two n8 B fragments whose k runs along rows k0..k0+15 and n
// along cols n0..n0+15 (B stored row-major, read with .trans).
__device__ __forceinline__ int a_lane(int r0, int c0, int lane) {
  return (r0 + (lane >> 3 & 1) * 8 + (lane & 7)) * TILE_LD + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int bt_lane(int n0, int c0, int lane) {
  return (n0 + (lane >> 4) * 8 + (lane & 7)) * TILE_LD + c0 + (lane >> 3 & 1) * 8;
}
__device__ __forceinline__ int b_lane(int k0, int n0, int lane) {
  return (k0 + (lane >> 3 & 1) * 8 + (lane & 7)) * TILE_LD + n0 + (lane >> 4) * 8;
}

// The products of a k step are summed into a zeroed accumulator, smallest
// terms first, which is then added to the running sum in fp32: the tensor
// cores' rounding of a sum then applies to one k step's partial and not
// to the running total.
template <int R, int C>
__device__ __forceinline__ void add_to(float (&acc)[R][C],
                                       const float (&st)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] += st[r][c];
}

// st (16 x 32) += the terms i <= imax of A (a[r][i], the 3-term fragments
// of 16 x 16) times B (two x4 fragments of 16 x 16 each), smallest first.
__device__ __forceinline__ void mma_terms(float (&st)[4][4],
                                          const uint32_t (&a)[4][3],
                                          const uint32_t (&bb)[2][4],
                                          int imax) {
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    if (i > imax) continue;
    const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma_bf16(st[n], ai, bb[n / 2][(n % 2) * 2], bb[n / 2][(n % 2) * 2 + 1]);
  }
}

// One level of warp_reduce_scatter: lanes whose bit `32 W / N` is set
// keep v[W..2W) and send v[0..W), the others the reverse, then the next
// level on the W they kept. W is a template constant, so that every index
// of v is one: with a loop bound that changes by level, nvcc leaves the
// loop rolled and indexes v through chains of predicated moves.
template <int W, int N, typename V>
__device__ __forceinline__ void reduce_level(V (&v)[N], int lane) {
  if constexpr (W >= 1) {
    constexpr int off = 32 * W / N;
    const bool up = lane & off;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const V send = up ? v[q] : v[q + W];
      const V keep = up ? v[q + W] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    reduce_level<W / 2, N>(v, lane);
  }
}

// Sums v (float or double) over the warp's 32 lanes, scattered: lane l
// returns the total of v[(l >> (5 - log2 N)) & (N - 1)] (N a power of
// two, at most 16), with N - 1 + 5 - log2 N shuffles instead of 5 N.
template <int N, typename V>
__device__ __forceinline__ V warp_reduce_scatter(V (&v)[N]) {
  static_assert(N >= 1 && N <= 16 && (N & (N - 1)) == 0,
                "N a power of two, at most 16");
  reduce_level<N / 2, N>(v, threadIdx.x % 32);
#pragma unroll
  for (int off = 16 / N; off >= 1; off /= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

// ---- What both wkv scans share (wkv_scan.cu and its backward) ----
namespace wkv {

constexpr int NT = 256;                  // threads a block: 8 warps
constexpr int QM = 64, HM = 64;          // chunk and hd maxima
constexpr int SB = 16, NSB = QM / SB;    // sub-blocks of a chunk

// Thread (c, I) = (tid % 64, tid / 64) owns channel c of sub-block I
// (steps 16 I .. 16 I + 15 of the chunk): its logw and, for each of `n`
// more tensors, its values, 0 past Q and past hd. Every load is issued
// before any is used. P is a kernel's Params (logw, nh, hd, Q).
template <typename T, int N, typename P>
__device__ __forceinline__ void own_steps(const P& p, size_t base,
                                          const T* const (&src)[N],
                                          float (&w)[SB],
                                          float (&vals)[N][SB]) {
  const int c = threadIdx.x % HM, I = threadIdx.x / HM;
  const size_t row = (size_t)p.nh * p.hd;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int i = I * SB + s;
    const bool in = c < p.hd && i < p.Q;
    const size_t off = base + (size_t)(in ? i : 0) * row + (in ? c : 0);
    w[s] = in ? p.logw[off] : 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) vals[n][s] = in ? load(src[n], off) : 0.0f;
  }
}

// L[s] = logw summed over the sub-block's steps 0..s, in double.
__device__ __forceinline__ void local_cumsum(const float (&w)[SB],
                                             double (&L)[SB]) {
  double run = 0.0;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    run += (double)w[s];
    L[s] = run;
  }
}

}  // namespace wkv
