// Backward of the RWKV6 WKV scan (csrc/wkv_scan.cu) for sm_90a.
//
// No TPU kernel: the reference differentiates its jnp chunked scan
// `wkv_chunk_scan` (src/repro/models/rwkv.py:64) with jax.grad. This is
// the backward of the `torch.autograd.Function` in
// kernels/wkv_scan/ops.py, whose forward is the wkv_scan kernel. Its
// oracle is `ref.py::wkv_scan_bwd_ref`. With the forward
//   y_t = S_t^T r_t + (r_t . (u k_t)) v_t,
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T,   w_t = e^{logw_t},
// and dS_S = d s_T (zeros when s_T carries no gradient), walking t down:
//   dr_t = S_t dy_t + (u k_t)(v_t . dy_t)
//   dk_t = dS_{t+1} v_t + (u r_t)(v_t . dy_t)
//   dv_t = dS_{t+1}^T k_t + (r_t . (u k_t)) dy_t
//   du  += r_t k_t (v_t . dy_t)            (over batch and time)
//   dlogw_t = w_t rowsum(dS_{t+1} S_t)     (elementwise product)
//   dS_t = diag(w_t) dS_{t+1} + r_t dy_t^T,  ds0 = dS_0.
// Row i of S and of dS is a scalar recurrence per column with the factor
// w_t[i] <= 1 alone, so every value stays finite at any logw < 0.
//
// Inputs: r, k, v, dy (B, S, nh, hd) of one dtype (fp32 or bf16), logw
// (B, S, nh, hd) and u (nh, hd) fp32, the forward's chunk scratch
// `states` (B, nh, S / Q, hd, hd) fp32, which the forward's state pass
// leaves holding h_{c-1}, the state entering chunk c; d s_T (B, nh, hd,
// hd) fp32 or null. Outputs: dr, dk of r's dtype; dv, dlogw fp32 (B, S,
// nh, hd); du (nh, hd) fp32; ds0 (B, nh, hd, hd) fp32 or null. dv and du
// are sums over blocks, taken with fp32 atomics into buffers the wrapper
// has zeroed (their order, so their last bits, vary from run to run);
// the wrapper casts dv to v's dtype.
//
// The design, a simple one. A block owns 16 rows i of S for one (batch,
// head): warp w rows 2w, 2w + 1, lane l columns l and l + 32; at the
// training shape (B, S, nh, hd) = (4, 2048, 40, 64) that is 4 x 40 x 4 =
// 640 blocks, row groups fastest so that the blocks of one head read v
// and dy from L2. It walks the chunks from the last: stages the chunk's
// r, k, w = e^{logw} (its rows) and v, dy (all columns) in shared memory
// with v . dy per step; recomputes the states of the chunk forward from
// h_{c-1}, keeping the one entering each 16-step sub-block; then walks
// each sub-block backward with its 16 states in registers: the row sums
// of dr, dk and dlogw are warp reductions, the column sums of dv shared
// atomics, added to dv with one global atomic per (step, column) and
// block. What bounds it at the training shape: the function reads r,
// k, v, dy (bf16) and logw (fp32) and writes dr, dk, dv (bf16) and dlogw
// (fp32), 461 MB (0.138 ms at 3.35 TB/s; the 84 MB of chunk states it
// also reads are this design's choice); its least work, the chunked
// form's products on the tensor cores, is twice the forward's, 1.2e10
// FLOP at 6 bf16 products a multiply-add of two fp32 factors (0.071
// ms). So it is bound by bytes (chip_smoke.py computes this bound). This
// version does the recurrence on the FMA units instead, about 16 FLOP a
// (step, row, column), 2.1e10 FLOP (0.32 ms at 67 TFLOP/s), and spends
// more instruction slots on the warp shuffles of its row sums than on
// arithmetic: tensor cores, chunk-parallel reverse passes and a
// reduce-scatter of a sub-block's row sums are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;              // threads a block: 8 warps
constexpr int RW = 2;                // rows of S a warp
constexpr int RB = 8 * RW;           // rows of S a block
constexpr int QM = 64, HM = 64;      // chunk and hd maxima
constexpr int SB = 16, NSB = QM / SB;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* dy;
  const float* logw;
  const float* u;
  const float* states;   // (B, nh, nc, hd, hd): h_{c-1}
  const float* dsT;      // nullptr: zeros
  void* dr;
  void* dk;
  float* dv;             // zeroed by the wrapper
  float* dlogw;
  float* du;             // zeroed by the wrapper
  float* ds0;            // nullptr: not wanted
  int B, S, nh, hd, Q, nc;
};

// Shared memory, in floats.
constexpr int OFF_R = 0, OFF_K = OFF_R + QM * RB, OFF_W = OFF_K + QM * RB;
constexpr int OFF_V = OFF_W + QM * RB, OFF_DY = OFF_V + QM * HM;
constexpr int OFF_VDY = OFF_DY + QM * HM, OFF_DV = OFF_VDY + QM;
constexpr int OFF_DR = OFF_DV + QM * HM, OFF_DK = OFF_DR + QM * RB;
constexpr int OFF_DW = OFF_DK + QM * RB, OFF_BND = OFF_DW + QM * RB;
constexpr int OFF_U = OFF_BND + NSB * RB * HM;
constexpr int SMEM_FLOATS = OFF_U + RB;
constexpr size_t SMEM = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv_scan_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Rs = sm + OFF_R;     // [QM][RB]
  float* Ks = sm + OFF_K;
  float* Ws = sm + OFF_W;     // e^{logw}
  float* Vs = sm + OFF_V;     // [QM][HM]
  float* DYs = sm + OFF_DY;
  float* VDY = sm + OFF_VDY;  // [QM]: v_t . dy_t
  float* DV = sm + OFF_DV;    // [QM][HM]: the block's dv sums
  float* DR = sm + OFF_DR;    // [QM][RB]
  float* DK = sm + OFF_DK;
  float* DW = sm + OFF_DW;
  float* BND = sm + OFF_BND;  // [NSB][RB][HM]: states entering sub-blocks
  float* U = sm + OFF_U;      // [RB]

  const int i0 = blockIdx.x * RB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = (size_t)p.nh * p.hd;      // one step of (B, S, nh, hd)
  const size_t bh = (size_t)b * p.nh + h;
  const size_t hd2 = (size_t)p.hd * p.hd;
  const T* R = static_cast<const T*>(p.r);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  const T* DYg = static_cast<const T*>(p.dy);

  if (tid < RB) U[tid] = i0 + tid < p.hd ? p.u[h * p.hd + i0 + tid] : 0.0f;
  for (int e = tid; e < QM * HM; e += NT) DV[e] = 0.0f;

  // dS of this thread's rows (warp * RW + rr) and columns (lane, lane + 32)
  float dS[RW][2];
  float du_acc[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int i = i0 + warp * RW + rr;
    du_acc[rr] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int j = lane + 32 * cc;
      dS[rr][cc] = (p.dsT != nullptr && i < p.hd && j < p.hd)
          ? p.dsT[bh * hd2 + (size_t)i * p.hd + j] : 0.0f;
    }
  }

  for (int c = p.nc - 1; c >= 0; --c) {
    const size_t base = ((size_t)b * p.S + (size_t)c * p.Q) * row
        + (size_t)h * p.hd;
    __syncthreads();   // the previous chunk's shared data is read out
    // Stage the chunk: steps past Q and rows or columns past hd are
    // r = k = v = dy = 0, w = 1, which leave S and dS unchanged.
    for (int e = tid; e < QM * RB; e += NT) {
      const int t = e / RB, li = e % RB, i = i0 + li;
      const bool in = t < p.Q && i < p.hd;
      const size_t off = base + (size_t)t * row + i;
      Rs[e] = in ? load(R, off) : 0.0f;
      Ks[e] = in ? load(K, off) : 0.0f;
      Ws[e] = in ? expf(p.logw[off]) : 1.0f;
    }
    for (int e = tid; e < QM * HM; e += NT) {
      const int t = e / HM, j = e % HM;
      const bool in = t < p.Q && j < p.hd;
      const size_t off = base + (size_t)t * row + j;
      Vs[e] = in ? load(V, off) : 0.0f;
      DYs[e] = in ? load(DYg, off) : 0.0f;
    }
    __syncthreads();
    for (int t = warp; t < QM; t += 8)
      VDY[t] = warp_sum(Vs[t * HM + lane] * DYs[t * HM + lane]
                        + Vs[t * HM + lane + 32] * DYs[t * HM + lane + 32]);
    __syncthreads();

    // The states entering each sub-block, forward from h_{c-1}.
    const int nsb = (p.Q + SB - 1) / SB;
    float S[RW][2];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int li = warp * RW + rr, i = i0 + li;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = lane + 32 * cc;
        S[rr][cc] = (i < p.hd && j < p.hd)
            ? p.states[(bh * p.nc + c) * hd2 + (size_t)i * p.hd + j] : 0.0f;
        BND[li * HM + j] = S[rr][cc];
      }
    }
    for (int t = 0; t < (nsb - 1) * SB; ++t) {
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int li = warp * RW + rr;
        const float w = Ws[t * RB + li], k = Ks[t * RB + li];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          S[rr][cc] = fmaf(w, S[rr][cc], k * Vs[t * HM + lane + 32 * cc]);
      }
      if ((t + 1) % SB == 0) {
#pragma unroll
        for (int rr = 0; rr < RW; ++rr)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            BND[(((t + 1) / SB) * RB + warp * RW + rr) * HM + lane + 32 * cc]
                = S[rr][cc];
      }
    }
    __syncwarp();

    for (int sb = nsb - 1; sb >= 0; --sb) {
      float Sh[SB][RW][2];   // S_t for the sub-block's steps
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          S[rr][cc] = BND[(sb * RB + warp * RW + rr) * HM + lane + 32 * cc];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const int t = sb * SB + s;
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int li = warp * RW + rr;
          const float w = Ws[t * RB + li], k = Ks[t * RB + li];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            Sh[s][rr][cc] = S[rr][cc];
            S[rr][cc] = fmaf(w, S[rr][cc], k * Vs[t * HM + lane + 32 * cc]);
          }
        }
      }
#pragma unroll
      for (int s = SB - 1; s >= 0; --s) {
        const int t = sb * SB + s;
        const float vdy = VDY[t];
        float dyj[2], vj[2], dvj[2] = {0.0f, 0.0f};
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          dyj[cc] = DYs[t * HM + lane + 32 * cc];
          vj[cc] = Vs[t * HM + lane + 32 * cc];
        }
        float pr[RW], pk[RW], pw[RW];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int li = warp * RW + rr;
          const float r = Rs[t * RB + li], k = Ks[t * RB + li];
          const float w = Ws[t * RB + li], uk = U[li] * k;
          pr[rr] = pk[rr] = pw[rr] = 0.0f;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float d = dS[rr][cc], st = Sh[s][rr][cc];
            pr[rr] = fmaf(st, dyj[cc], pr[rr]);
            pk[rr] = fmaf(d, vj[cc], pk[rr]);
            pw[rr] = fmaf(d, st, pw[rr]);
            dvj[cc] = fmaf(d, k, fmaf(r * uk, dyj[cc], dvj[cc]));
            dS[rr][cc] = fmaf(w, d, r * dyj[cc]);
          }
          du_acc[rr] = fmaf(r * k, vdy, du_acc[rr]);
        }
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          pr[rr] = warp_sum(pr[rr]);
          pk[rr] = warp_sum(pk[rr]);
          pw[rr] = warp_sum(pw[rr]);
        }
        if (lane == 0) {
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            const int li = warp * RW + rr;
            const float r = Rs[t * RB + li], k = Ks[t * RB + li];
            DR[t * RB + li] = fmaf(U[li] * k, vdy, pr[rr]);
            DK[t * RB + li] = fmaf(U[li] * r, vdy, pk[rr]);
            DW[t * RB + li] = Ws[t * RB + li] * pw[rr];
          }
        }
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          atomicAdd(&DV[t * HM + lane + 32 * cc], dvj[cc]);
      }
    }
    __syncthreads();
    // The chunk's results: dr, dk, dlogw of the block's rows; dv sums.
    T* dR = static_cast<T*>(p.dr);
    T* dK = static_cast<T*>(p.dk);
    for (int e = tid; e < QM * RB; e += NT) {
      const int t = e / RB, i = i0 + e % RB;
      if (t >= p.Q || i >= p.hd) continue;
      const size_t off = base + (size_t)t * row + i;
      store(dR, off, DR[e]);
      store(dK, off, DK[e]);
      p.dlogw[off] = DW[e];
    }
    for (int e = tid; e < QM * HM; e += NT) {
      const int t = e / HM, j = e % HM;
      const float x = DV[e];
      DV[e] = 0.0f;
      if (t < p.Q && j < p.hd) atomicAdd(p.dv + base + (size_t)t * row + j, x);
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int i = i0 + warp * RW + rr;
    if (i >= p.hd) continue;
    if (lane == 0) atomicAdd(p.du + h * p.hd + i, du_acc[rr]);
    if (p.ds0 != nullptr)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = lane + 32 * cc;
        if (j < p.hd) p.ds0[bh * hd2 + (size_t)i * p.hd + j] = dS[rr][cc];
      }
  }
}

}  // namespace

// dtype (of r, k, v, dy, dr, dk): 0 = float32, 1 = bfloat16. dsT and ds0
// may be null. dv (B, S, nh, hd) and du (nh, hd) must be zeroed fp32.
// Returns the launch's CUDA error (0 on success); the wrapper raises on
// anything else. The wrapper has checked Q <= 64, hd <= 64, S % Q == 0.
extern "C" int wkv_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* dy,
    const void* logw, const void* u, const void* states, const void* dsT,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,
    int dtype, int B, int S, int nh, int hd, int Q, void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{r, k, v, dy, static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(states),
           static_cast<const float*>(dsT), dr, dk, static_cast<float*>(dv),
           static_cast<float*>(dlogw), static_cast<float*>(du),
           static_cast<float*>(ds0), B, S, nh, hd, Q, S / Q};
  const dim3 grid((hd + RB - 1) / RB, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_opt_in<wkv_scan_bwd_kernel<float>>(grid, NT, SMEM,
                                                          SMEM, p, s);
  if (dtype == 1)
    return (int)launch_opt_in<wkv_scan_bwd_kernel<__nv_bfloat16>>(
        grid, NT, SMEM, SMEM, p, s);
  return (int)cudaErrorInvalidValue;
}
