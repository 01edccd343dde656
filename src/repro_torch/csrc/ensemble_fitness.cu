// ensemble_fitness for Hopper (sm_90a): score N clients' NSGA-II
// populations in one launch.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ensemble_fitness/
// kernel.py: `ensemble_fitness` (pallas_call at :77, one client) and
// `ensemble_fitness_batched` (pallas_call at :109, grid (N, P/128)).
// For each client n and chromosome row p (0/1 floats, k ones):
//
//   strength[n,p]  = (C @ acc)[p] / max(k, 1)
//   diversity[n,p] = 1 - (rowsum((C @ S) o C)[p] - (C @ diag S)[p])
//                        / max(k (k - 1), 1)
//
// Design. The TPU version keeps all of S resident in VMEM; a Hopper
// block has at most 227 KB of shared memory and S is already 400 KB at
// M = 320, so S is streamed through shared memory in TILE x TILE tiles
// instead. Grid (N, ceil(P / BLOCK_P)); a block of TILE x ROW_GROUPS
// threads owns BLOCK_P chromosome rows of one client. Thread (ty, tx)
// accumulates (C @ S)[p, j0 + tx] for its ROWS_PER_THREAD rows over the
// i-tiles of one column tile j0, then folds that column into the
// quadratic form, C @ acc, C @ diag S and k. One warp holds the 32
// columns of ROWS_PER_THREAD rows, so the final row sums are warp
// shuffles. Ragged edges (P, M not multiples of the tile) load zeros.
// Plain fp32 FMA, no tensor cores and no TF32: the result matches the
// plain version to about 1e-6.
//
// Bound at the main path's shapes (N = 32, P = 200, M = 100) on an H100
// SXM: 2 N P M^2 = 1.28e8 FLOP at 67 TFLOP/s fp32 is about 1.9 us; the
// 3.9 MB the function must move at 3.35 TB/s is about 1.2 us. So it is
// bound by operations, and at these sizes by launch latency in practice.
// Rows hold exactly k ones, so a gather over the k^2 entries of S per row
// would cut the operations to N P k^2; that redesign is later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;              // columns of S per tile = warp width
constexpr int ROW_GROUPS = 8;         // warps per block
constexpr int ROWS_PER_THREAD = 4;
constexpr int BLOCK_P = ROW_GROUPS * ROWS_PER_THREAD;   // 32 rows a block

__global__ void __launch_bounds__(TILE * ROW_GROUPS)
ensemble_fitness_kernel(const float* __restrict__ pop,
                        const float* __restrict__ acc,
                        const float* __restrict__ S,
                        const float* __restrict__ diag,
                        float* __restrict__ strength,
                        float* __restrict__ diversity,
                        int P, int M) {
  __shared__ float c_tile[BLOCK_P][TILE + 1];   // C[p0 + r, i0 + i]
  __shared__ float s_tile[TILE][TILE + 1];      // S[i0 + i, j0 + j]

  const int n = blockIdx.x;
  const int p0 = blockIdx.y * BLOCK_P;
  const int tx = threadIdx.x;                   // column within the tile
  const int ty = threadIdx.y;                   // row group = warp
  const float* pop_n = pop + (size_t)n * P * M;
  const float* S_n = S + (size_t)n * M * M;
  const float* acc_n = acc + (size_t)n * M;
  const float* diag_n = diag + (size_t)n * M;

  float quad[ROWS_PER_THREAD], st[ROWS_PER_THREAD], self_sim[ROWS_PER_THREAD],
      kcount[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    quad[r] = 0.f; st[r] = 0.f; self_sim[r] = 0.f; kcount[r] = 0.f;
  }

  for (int j0 = 0; j0 < M; j0 += TILE) {
    const int j = j0 + tx;
    float cs[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) cs[r] = 0.f;

    for (int i0 = 0; i0 < M; i0 += TILE) {
      // stage C[p0:p0+BLOCK_P, i0:i0+TILE] and S[i0:i0+TILE, j0:j0+TILE]
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        const int row = ty + ROW_GROUPS * r;
        const int p = p0 + row, i = i0 + tx;
        c_tile[row][tx] = (p < P && i < M) ? pop_n[(size_t)p * M + i] : 0.f;
      }
      for (int row = ty; row < TILE; row += ROW_GROUPS) {
        const int i = i0 + row;
        s_tile[row][tx] = (i < M && j < M) ? S_n[(size_t)i * M + j] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < TILE; ++i) {
        const float s = s_tile[i][tx];
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r)
          cs[r] = fmaf(c_tile[ty + ROW_GROUPS * r][i], s, cs[r]);
      }
      __syncthreads();
    }

    // fold column j into the row sums
    const float a = (j < M) ? acc_n[j] : 0.f;
    const float d = (j < M) ? diag_n[j] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int p = p0 + ty + ROW_GROUPS * r;
      const float c = (p < P && j < M) ? pop_n[(size_t)p * M + j] : 0.f;
      quad[r] = fmaf(cs[r], c, quad[r]);
      st[r] = fmaf(c, a, st[r]);
      self_sim[r] = fmaf(c, d, self_sim[r]);
      kcount[r] += c;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
#pragma unroll
    for (int off = TILE / 2; off > 0; off >>= 1) {
      quad[r] += __shfl_down_sync(0xffffffffu, quad[r], off);
      st[r] += __shfl_down_sync(0xffffffffu, st[r], off);
      self_sim[r] += __shfl_down_sync(0xffffffffu, self_sim[r], off);
      kcount[r] += __shfl_down_sync(0xffffffffu, kcount[r], off);
    }
    const int p = p0 + ty + ROW_GROUPS * r;
    if (tx == 0 && p < P) {
      const float k = kcount[r];
      const float pairs = fmaxf(k * (k - 1.f), 1.f);
      strength[(size_t)n * P + p] = st[r] / fmaxf(k, 1.f);
      diversity[(size_t)n * P + p] = 1.f - (quad[r] - self_sim[r]) / pairs;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous fp32 arrays: pop (N, P, M), acc (N, M), S (N, M, M),
// diag (N, M), strength and diversity (N, P). Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); no synchronise.
extern "C" int ensemble_fitness_launch(const float* pop, const float* acc,
                                       const float* S, const float* diag,
                                       float* strength, float* diversity,
                                       int N, int P, int M, void* stream) {
  if (N <= 0 || P <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)N, (unsigned)((P + BLOCK_P - 1) / BLOCK_P));
  const dim3 block(TILE, ROW_GROUPS);
  ensemble_fitness_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pop, acc, S, diag, strength, diversity, P, M);
  return (int)cudaGetLastError();
}
