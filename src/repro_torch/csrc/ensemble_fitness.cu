// ensemble_fitness for Hopper (sm_90a): score N clients' NSGA-II
// populations in one launch, in gather form.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ensemble_fitness/
// kernel.py: `ensemble_fitness` (pallas_call at :77, one client) and
// `ensemble_fitness_batched` (pallas_call at :109, grid (N, P/128)).
// For each client n and chromosome row p (c = pop[n, p], k = sum_i c_i):
//
//   strength[n,p]  = (c . acc[n]) / max(k, 1)
//   diversity[n,p] = 1 - (c S[n] c^T - sum_i c_i S[n,i,i])
//                        / max(k (k - 1), 1)
//
// written to one (N, P, 2) buffer as (strength, diversity).
//
// What bounds it. On the main path (N = 32 clients, P = 200 rows, M =
// 100 models) rows are 0/1 with k = 5 ones (NSGA-II chromosomes), so the
// function needs pop whole (2.56 MB), the entries of acc and S that the
// rows' nonzeros pick (at most 12.8 KB and 1.28 MB) and the outputs (51
// KB): about 1 us at 3.35 TB/s, and N P (k^2 + 3 k) multiply-adds, far
// less. TPU-style dense form, C S C^T, costs 2 N P M^2 = 1.28e8 FLOP.
//
// Design: the gather form. One warp a row (n, p), 8 rows a block. The
// warp reads the row with 16-byte loads (element loads when M is not a
// multiple of 4), compacts its nonzero indices and values into shared
// memory with __ballot_sync and __popc, then sums c_a c_b S[n, i_a, i_b]
// over the nnz^2 pairs of nonzeros (lanes over the flattened pairs) and
// c_a acc[n, i_a], c_a S[n, i_a, i_a] and c_a over the nonzeros, and
// reduces the four sums with shuffles. Weighting by the values keeps the
// function the same for any row, non-binary and dense rows included; a
// row of nnz nonzeros reads nnz^2 entries of S (25 at k = 5, from L2:
// S is 40 KB a client). No diag(S) copy and no second output buffer.
// Shared memory holds M (index, value) pairs a warp; the block takes
// fewer warps, and opts in above 48 KB, when M is large (M <= 29056).
// Plain fp32 FMA: the sums follow another order than the plain version's
// matrix products, within about 1e-7 at the main path's sizes.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;                      // rows a block, at most
constexpr size_t MAX_SMEM = 227 * 1024;       // a block's shared memory
constexpr int MAX_M = (int)(MAX_SMEM / 8);    // one warp a block

struct Params {
  const float* pop;    // (N, P, M)
  const float* acc;    // (N, M)
  const float* S;      // (N, M, M)
  float* out;          // (N, P, 2): strength, diversity
  int rows, P, M;      // rows = N P
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Appends this lane's x (at index i) to the warp's list when nonzero.
__device__ __forceinline__ void push(float x, int i, int lane, int& n,
                                     int* idx, float* val) {
  const bool nz = x != 0.0f;
  const unsigned mask = __ballot_sync(0xffffffffu, nz);
  if (nz) {
    const int at = n + __popc(mask & ((1u << lane) - 1u));
    idx[at] = i;
    val[at] = x;
  }
  n += __popc(mask);
}

__global__ void __launch_bounds__(WARPS * 32)
ensemble_fitness_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, M = p.M;
  int* idx = reinterpret_cast<int*>(smem) + (size_t)warp * M;
  float* val = reinterpret_cast<float*>(smem)
      + (size_t)warps * M + (size_t)warp * M;
  const int r = blockIdx.x * warps + warp;
  if (r >= p.rows) return;                    // a whole warp leaves
  const int n = r / p.P;
  const float* row = p.pop + (size_t)r * M;

  int nnz = 0;
  if (M % 4 == 0) {                           // rows are 16-byte aligned
    for (int base = 0; base < M; base += 128) {
      const int i = base + 4 * lane;
      const float4 x = i < M ? __ldg(reinterpret_cast<const float4*>(row + i))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      push(x.x, i, lane, nnz, idx, val);
      push(x.y, i + 1, lane, nnz, idx, val);
      push(x.z, i + 2, lane, nnz, idx, val);
      push(x.w, i + 3, lane, nnz, idx, val);
    }
  } else {
    for (int base = 0; base < M; base += 32) {
      const int i = base + lane;
      push(i < M ? __ldg(row + i) : 0.0f, i, lane, nnz, idx, val);
    }
  }
  __syncwarp();

  const float* acc = p.acc + (size_t)n * M;
  const float* S = p.S + (size_t)n * M * M;
  float st = 0.0f, self = 0.0f, k = 0.0f, quad = 0.0f;
  for (int a = lane; a < nnz; a += 32) {
    const int i = idx[a];
    const float c = val[a];
    st = fmaf(c, __ldg(acc + i), st);
    self = fmaf(c, __ldg(S + (size_t)i * M + i), self);
    k += c;
  }
  for (int q = lane; q < nnz * nnz; q += 32) {
    const int a = q / nnz, b = q - a * nnz;
    quad = fmaf(val[a] * val[b], __ldg(S + (size_t)idx[a] * M + idx[b]),
                quad);
  }
  st = warp_sum(st);
  self = warp_sum(self);
  k = warp_sum(k);
  quad = warp_sum(quad);
  if (lane == 0) {
    const float pairs = fmaxf(k * (k - 1.0f), 1.0f);
    *reinterpret_cast<float2*>(p.out + (size_t)r * 2) =
        make_float2(st / fmaxf(k, 1.0f), 1.0f - (quad - self) / pairs);
  }
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous fp32 arrays: pop (N, P, M), acc (N, M), S (N, M, M) and out
// (N, P, 2). Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); no synchronise. M is at most 29056.
extern "C" int ensemble_fitness_launch(const float* pop, const float* acc,
                                       const float* S, float* out, int N,
                                       int P, int M, void* stream) {
  if (N <= 0 || P <= 0 || M <= 0 || M > MAX_M)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)N * P;
  const int warps = (int)(MAX_SMEM / (8 * (size_t)M)) < WARPS
      ? (int)(MAX_SMEM / (8 * (size_t)M)) : WARPS;
  const Params p{pop, acc, S, out, (int)rows, P, M};
  return (int)launch_opt_in<ensemble_fitness_kernel>(
      dim3((unsigned)((rows + warps - 1) / warps)), warps * 32, MAX_SMEM,
      (size_t)warps * M * 8, p, static_cast<cudaStream_t>(stream));
}
