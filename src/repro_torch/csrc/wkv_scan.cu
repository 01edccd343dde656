// RWKV6 chunked WKV scan (per-channel, data-dependent decay) for sm_90a.
//
// Replaces the Pallas TPU kernel `wkv_scan` of
// src/repro/kernels/wkv_scan/kernel.py:64 (`_kernel`, pallas_call :76).
// Same function, same contract as its oracle `ref.py::wkv_scan_ref`:
//   r, k, v (B, S, nh, hd) of one dtype (fp32 or bf16), logw (B, S, nh,
//   hd) fp32 (< 0), u (nh, hd) fp32, an optional initial state s0 (B, nh,
//   hd, hd) fp32 (none: zeros);
//   y (B, S, nh, hd) of r's dtype and the final state s_T (B, nh, hd, hd)
//   fp32:
//     y_t = s_t^T r_t + (r_t . (u k_t)) v_t,
//     s_{t+1} = diag(exp(logw_t)) s_t + k_t v_t^T.
//   S is a multiple of the chunk Q (the wrapper in ops.py pads with
//   r = k = v = logw = 0 steps, which leave s_T exact).
//
// Per chunk of Q steps, with cum = cumsum(logw) per channel and
// cum_prev = cum - logw, as the TPU kernel computes it:
//   A[i, j] = sum_c r_i e^{cum_prev_i} k_j e^{-cum_j}   for j < i
//   y = A v + (sum_c r u k) v + (r e^{cum_prev}) @ s_prev
//   s = e^{cum_Q} s_prev + (k e^{cum_Q - cum})^T v
// in fp32 throughout (plain FMA; bf16 converted on load, y rounded to its
// dtype on store). The TPU kernel forms A from the two factors r
// e^{cum_prev} and k e^{-cum}; e^{-cum} overflows fp32 once a channel
// decays by more than e^{-88} within the chunk (a mean logw below -1.4
// over 64 steps; RWKV6 decays reach logw = -7), and A turns to inf * 0 =
// NaN where the recurrence is finite. This kernel splits the chunk into
// sub-blocks of 16 steps and never forms a positive exponent: for i in
// sub-block I and j in an earlier sub-block J,
//   A[i, j] = sum_c (r_i e^{cum_prev_i - cum_prev_b(I)})
//                   g_IJ (k_j e^{cum_e(J) - cum_j}),
//   g_IJ = e^{cum_prev_b(I) - cum_e(J)}   (1 for J = I - 1),
// with b(I) the first and e(J) the last step of a sub-block; inside a
// sub-block, A[i, j] = sum_c r_i k_j e^{cum_prev_i - cum_j}, one exp a
// term. Every factor is at most 1, so it is finite wherever the
// recurrence is (an underflow to 0 stands for a term below 1e-38).
//
// What bounds it. The serving slice (rwkv6-3b prefill, batch 4) calls it
// at (B, S, nh, hd) = (4, 2048, 40, 64): r, k, v and y in bf16 (42 MB
// each), logw in fp32 (84 MB) and s_T (2.6 MB), about 0.076 ms at 3.35
// TB/s (0.077 ms with the carried state s0 the model passes). The least
// arithmetic that computes it is the chunked form at chunk 4: r_dec
// s_prev and the state update (4 hd^2 a step), the strictly lower A and
// A v, all fp32 (r and k meet the decays before any product), about
// 5.83e9 FLOP: 0.087 ms at the H100's 67 TFLOP/s fp32 rate, or 0.035 ms
// on the 989 TFLOP/s bf16 tensor cores with both fp32 factors split
// into 3 bf16 terms (6 products a multiply-add keep fp32 accuracy). The
// bound chip_smoke.py uses is the latter, so the call is bound by bytes,
// 0.077 ms (it prints the fp32-rate count beside it). At Q = 64 this
// kernel's form needs about 24.5k FLOP a (token, head) against the
// least 17.8k.
//
// What the design does about that. The TPU kernel's sequential chunk
// grid axis with s in VMEM scratch becomes a loop over chunks inside one
// block per (batch, head); blocks run in no order, so nothing crosses
// blocks. The block reads the model layout (B, S, nh, hd) in place (row
// stride nh hd). A chunk's operands, A and s (about 153 KB at Q = hd =
// 64) stay in shared memory, opted in above 48 KB once, rows padded by
// one word against bank conflicts. The cumsum runs over channels in
// parallel (4 segments a channel, then their prefix). Each product gives
// every thread of 256 a 4 x 4 register micro-tile; in the A product the
// micro-tile's row a and column e fall in sub-blocks a and e, so the
// rebasing costs one multiply by g for three of its sixteen entries and
// 64 exps for the diagonal ones. At rwkv6's width that is 160 blocks of
// 256 threads on 132 SMs, one block an SM: a second, mostly idle wave.
// Splitting the state's value columns over blocks, and the tensor cores,
// are left to a later change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block: a 16 x 16 grid
constexpr int QMAX = 64, HDMAX = 64;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;     // nullptr: zeros
  void* y;
  float* sT;
  int B, S, nh, hd, Q;
};

__host__ __device__ constexpr int segments(int hd) {
  return NT / hd < 8 ? NT / hd : 8;
}

__host__ __device__ constexpr size_t smem_floats(int Q, int hd) {
  return 7 * (size_t)Q * (hd + 1)    // r, k, v, logw, cum, rr, kk
      + (size_t)Q * (Q + 1)          // A
      + (size_t)hd * hd              // s
      + (size_t)Q                    // bonus diagonal
      + (size_t)hd                   // exp(cum_Q)
      + 8 * (size_t)hd               // segment totals of the cumsum
      + 3 * (size_t)hd;              // g for sub-blocks (2,0) (3,0) (3,1)
}

template <typename T>
__global__ void __launch_bounds__(NT) wkv_scan_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, hd = p.hd;
  const int LD = hd + 1, LDA = Q + 1;
  float* Rs = sm;                  // Q x LD: r, then r e^{cum_prev}
  float* Ks = Rs + Q * LD;         // Q x LD: k, then k e^{cum_Q - cum}
  float* Vs = Ks + Q * LD;         // Q x LD: v
  float* Ws = Vs + Q * LD;         // Q x LD: logw, then cum_prev
  float* Cs = Ws + Q * LD;         // Q x LD: cum
  float* RR = Cs + Q * LD;         // Q x LD: r e^{cum_prev - cum_prev_b}
  float* KK = RR + Q * LD;         // Q x LD: k e^{cum_e - cum}
  float* As = KK + Q * LD;         // Q x LDA
  float* ss = As + Q * LDA;        // hd x hd: the state
  float* bonus = ss + hd * hd;     // Q
  float* ecq = bonus + Q;          // hd: exp(cum_Q)
  float* tot = ecq + hd;           // 8 x hd
  float* G = tot + 8 * hd;         // 3 x hd

  const int bh = blockIdx.x, b = bh / p.nh, h = bh % p.nh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* R = static_cast<const T*>(p.r);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* Y = static_cast<T*>(p.y);
  const float* U = p.u + (size_t)h * hd;
  const size_t row = (size_t)p.nh * hd;   // token stride
  const size_t base = (size_t)b * p.S * row + (size_t)h * hd;
  const int P = segments(hd);             // cumsum segments a channel
  const int L = (Q + P - 1) / P;          // steps a segment

  const float* S0 = p.s0 ? p.s0 + (size_t)bh * hd * hd : nullptr;
  for (int i = tid; i < hd * hd; i += NT) ss[i] = S0 ? S0[i] : 0.0f;

  // micro-tile rows ty + 16 a (sub-block a) and columns tx + 16 e
  // (sub-block e), clamped so that a thread past the edge reads valid
  // shared memory (its results are never stored)
  int q4[4], d4[4], qr[4], dr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    q4[a] = min(tx + 16 * a, Q - 1);
    d4[a] = min(tx + 16 * a, hd - 1);
    qr[a] = min(ty + 16 * a, Q - 1);
    dr[a] = min(ty + 16 * a, hd - 1);
  }

  for (int t0 = 0; t0 < p.S; t0 += Q) {
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = tid; idx < Q * hd; idx += NT) {
      const int i = idx / hd, c = idx % hd;
      const size_t off = base + (size_t)(t0 + i) * row + c;
      Rs[i * LD + c] = load(R, off);
      Ks[i * LD + c] = load(K, off);
      Vs[i * LD + c] = load(V, off);
      Ws[i * LD + c] = p.logw[off];
    }
    __syncthreads();

    // bonus_i = sum_c r_i[c] u[c] k_i[c]: one warp a row
    for (int i = warp; i < Q; i += NT / 32) {
      float d = 0.0f;
      for (int c = lane; c < hd; c += 32)
        d = fmaf(Rs[i * LD + c], U[c] * Ks[i * LD + c], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) bonus[i] = d;
    }
    // cumsum of logw per channel: segment g of channel c sums its L steps
    if (tid < P * hd) {
      const int c = tid % hd, g = tid / hd;
      float run = 0.0f;
      for (int i = g * L; i < min(Q, g * L + L); ++i) {
        run += Ws[i * LD + c];
        Cs[i * LD + c] = run;
      }
      tot[g * hd + c] = run;
    }
    __syncthreads();
    // cum = the segment's cumsum + the earlier segments' totals
    for (int idx = tid; idx < Q * hd; idx += NT) {
      const int i = idx / hd, c = idx % hd, g = i / L;
      float pre = 0.0f, all = 0.0f;
      for (int e = 0; e < P; ++e) {
        const float t = tot[e * hd + c];
        if (e < g) pre += t;
        all += t;
      }
      const float cum = Cs[i * LD + c] + pre;
      Cs[i * LD + c] = cum;
      Ws[i * LD + c] = cum - Ws[i * LD + c];      // cum_prev
      if (i == Q - 1) ecq[c] = expf(all);
    }
    __syncthreads();
    // the rebased operands of A's off-diagonal sub-blocks
    for (int idx = tid; idx < Q * hd; idx += NT) {
      const int i = idx / hd, c = idx % hd;
      const int first = i & ~15, last = min(first + 15, Q - 1);
      RR[i * LD + c] = Rs[i * LD + c]
          * expf(Ws[i * LD + c] - Ws[first * LD + c]);
      KK[i * LD + c] = Ks[i * LD + c]
          * expf(Cs[last * LD + c] - Cs[i * LD + c]);
    }
    for (int idx = tid; idx < 3 * hd; idx += NT) {
      const int pr = idx / hd, c = idx % hd;
      const int I = pr == 0 ? 2 : 3, J = pr == 2 ? 1 : 0;
      const int first = min(16 * I, Q - 1), last = min(16 * J + 15, Q - 1);
      G[idx] = expf(Ws[first * LD + c] - Cs[last * LD + c]);
    }
    __syncthreads();

    {   // A, strictly lower triangular
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
      for (int c = 0; c < hd; ++c) {   // sub-blocks I > J
        float rv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          rv[a] = RR[qr[a] * LD + c];
          kv[a] = KK[q4[a] * LD + c];
        }
        acc[1][0] = fmaf(rv[1], kv[0], acc[1][0]);
        acc[2][1] = fmaf(rv[2], kv[1], acc[2][1]);
        acc[3][2] = fmaf(rv[3], kv[2], acc[3][2]);
        acc[2][0] = fmaf(rv[2], G[c] * kv[0], acc[2][0]);
        acc[3][0] = fmaf(rv[3], G[hd + c] * kv[0], acc[3][0]);
        acc[3][1] = fmaf(rv[3], G[2 * hd + c] * kv[1], acc[3][1]);
      }
      if (tx < ty) {                   // inside a sub-block, j < i
        for (int c = 0; c < hd; ++c) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float e = expf(Ws[qr[a] * LD + c] - Cs[q4[a] * LD + c]);
            acc[a][a] = fmaf(Rs[qr[a] * LD + c] * Ks[q4[a] * LD + c], e,
                             acc[a][a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = tx + 16 * e;
          if (i < Q && j < Q) As[i * LDA + j] = j < i ? acc[a][e] : 0.0f;
        }
      }
    }
    __syncthreads();
    // r e^{cum_prev} and k e^{cum_Q - cum} replace r and k
    for (int idx = tid; idx < Q * hd; idx += NT) {
      const int i = idx / hd, c = idx % hd;
      Rs[i * LD + c] *= expf(Ws[i * LD + c]);
      Ks[i * LD + c] *= expf(Cs[(Q - 1) * LD + c] - Cs[i * LD + c]);
    }
    __syncthreads();

    {   // y = A v + bonus v + r_dec @ s_prev
      float acc[4][4], inter[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = inter[a][e] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        float av[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = As[qr[a] * LDA + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = Vs[j * LD + d4[e]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(av[a], vv[e], acc[a][e]);
      }
      for (int c = 0; c < hd; ++c) {
        float rv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) rv[a] = Rs[qr[a] * LD + c];
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = ss[c * hd + d4[e]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            inter[a][e] = fmaf(rv[a], sv[e], inter[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx + 16 * e;
          if (d >= hd) continue;
          const float yv = acc[a][e] + bonus[i] * Vs[i * LD + d];
          store(Y, base + (size_t)(t0 + i) * row + d, yv + inter[a][e]);
        }
      }
    }
    __syncthreads();   // every reader of s_prev is done

    {   // s = exp(cum_Q) s_prev + kw^T v
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        float kv[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) kv[a] = Ks[j * LD + dr[a]];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = Vs[j * LD + d4[e]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(kv[a], vv[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = ty + 16 * a;
        if (c >= hd) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx + 16 * e;
          if (d < hd) ss[c * hd + d] = ss[c * hd + d] * ecq[c] + acc[a][e];
        }
      }
    }
  }
  __syncthreads();
  float* ST = p.sT + (size_t)bh * hd * hd;
  for (int idx = tid; idx < hd * hd; idx += NT) ST[idx] = ss[idx];
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return launch_opt_in<wkv_scan_kernel<T>>(
      p.B * p.nh, NT, smem_floats(QMAX, HDMAX) * 4,
      smem_floats(p.Q, p.hd) * 4, p, stream);
}

}  // namespace

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16; s0 may be null.
// Returns the CUDA error of the launch (0 on success); the wrapper raises
// on anything else. The wrapper has checked Q <= 64, hd <= 64, S % Q == 0.
extern "C" int wkv_scan_launch(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* s0, void* y, void* sT, int dtype,
                               int B, int S, int nh, int hd, int Q,
                               void* stream) {
  if (Q < 1 || Q > QMAX || hd < 1 || hd > HDMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(s0), y,
           static_cast<float*>(sT), B, S, nh, hd, Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
