// Mamba2 SSD chunked scan for sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_scan` of
// src/repro/kernels/ssd_scan/kernel.py:73 (`_kernel`, pallas_call :88).
// Same function, same contract as its oracle `ref.py::ssd_scan_ref`:
//   x (Bb, S, nh, hd) and B/C (Bb, S, ds) of one dtype (fp32 or bf16),
//   dt (Bb, S, nh) fp32 (post-softplus), A_log and D (nh,) fp32;
//   y (Bb, S, nh, hd) of x's dtype and the final state h_T (Bb, nh, hd,
//   ds) fp32, from h_0 = 0:
//     h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t + D x_t,
//   A = -exp(A_log). S is a multiple of the chunk Q (the wrapper in
//   ops.py pads with dt = 0 steps, which leave h_T exact).
//
// Per chunk of Q steps, with cum = cumsum(dt A) over the chunk (every
// step's log decay is <= 0, so cum decreases and each exponent below is
// <= 0):
//   scores[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j      for j <= i
//   y = scores @ x + exp(cum_i) (C_i . h_prev) + D x
//   h = exp(cum_Q) h_prev + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// as the TPU kernel computes it, in fp32 (plain FMA; bf16 is converted
// on load, y rounded to its dtype on store), except cum, which is summed
// and differenced in double: in fp32 the difference of two cums near
// -100 keeps only about 1e-5 of its exp, which put y 1.4e-5 of max |y|
// from a float64 recurrence at zamba2's width on an H100; in double it
// is 3.7e-7.
//
// What bounds it. The serving slice (zamba2-7b prefill, batch 4) calls
// it at (Bb, S, nh, hd, ds) = (4, 2048, 112, 64, 64), x/B/C bf16: it
// moves x and y (117 MB each), B and C (1 MB each), dt (3.7 MB) and h_T
// (7.3 MB), about 0.074 ms at 3.35 TB/s. The least arithmetic that
// computes it is the chunked form at chunk 8: C h_prev and the state
// update (4 hd ds a step) and the causal scores @ x in fp32, about 1.60e10
// FLOP, with C B^T once a batch (shared by the heads) on the bf16 tensor
// cores, where bf16 products are exact: about 0.239 ms at the H100's 67
// TFLOP/s fp32 rate. It is bound by operations (chip_smoke.py computes
// this bound). At Q = 128 this kernel does about 2.8 times that work
// (49k FLOP a (token, head) against 17.5k): the whole Q x Q tile of C B^T
// for every head, and the whole tile of scores @ x.
//
// What the design does about that. The TPU kernel's sequential chunk
// grid axis with h in VMEM scratch becomes a loop over chunks inside one
// block per (batch, head): blocks run in no order, so nothing crosses
// blocks. The block reads the model layout (Bb, S, nh, hd) in place (row
// stride nh hd), and B and C at batch bh / nh with the caller's strides,
// never repeated across heads. A chunk's x, B, C, the Q x Q score tile
// and h (about 185 KB at Q = 128, hd = ds = 64) stay in shared memory,
// opted in above 48 KB once; rows of B, C, h and the score tile are
// padded by one word against bank conflicts. Each of the three products
// gives every thread of 256 a register micro-tile (8 x 8, 8 x 4, 4 x 4)
// fed by broadcast or conflict-free shared loads. This first version
// computes the whole Q x Q score tile and masks it (twice the causal
// work) and keeps one block of 256 threads on an SM: the tensor cores
// (TF32 or bf16 mma) and more blocks in flight are left to a later change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block: a 16 x 16 grid
constexpr int QMAX = 128, HDMAX = 64, DSMAX = 64;

struct Params {
  const void* x;
  const float* dt;
  const float* A_log;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* hT;
  int Bb, S, nh, hd, ds, Q;
  long long bc_bstride, bc_tstride;   // B and C strides, elements
};

__host__ __device__ constexpr size_t smem_floats(int Q, int hd, int ds) {
  return 2 * (size_t)Q               // cum, in double
      + (size_t)Q * hd               // x
      + 2 * (size_t)Q * (ds + 1)     // B, C
      + (size_t)Q * (Q + 1)          // scores
      + (size_t)hd * (ds + 1)        // h
      + 3 * (size_t)Q;               // dt, exp(cum), w
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) double smd[];
  const int Q = p.Q, hd = p.hd, ds = p.ds;
  const int LDS = ds + 1, LDQ = Q + 1;
  double* cum = smd;                    // Q: cumsum(dt A), in double
  float* xs = reinterpret_cast<float*>(cum + Q);   // Q x hd
  float* Bs = xs + Q * hd;              // Q x LDS
  float* Cs = Bs + Q * LDS;             // Q x LDS
  float* sc = Cs + Q * LDS;             // Q x LDQ
  float* hs = sc + Q * LDQ;             // hd x LDS
  float* dts = hs + hd * LDS;           // Q
  float* ecum = dts + Q;                // Q: exp(cum_i)
  float* wj = ecum + Q;                 // Q: exp(cum_Q - cum_j) dt_j

  const int bh = blockIdx.x, b = bh / p.nh, h = bh % p.nh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float A = -expf(p.A_log[h]);
  const float Dh = p.D[h];
  const T* X = static_cast<const T*>(p.x);
  const T* Bg = static_cast<const T*>(p.B);
  const T* Cg = static_cast<const T*>(p.C);
  T* Y = static_cast<T*>(p.y);
  const size_t row = (size_t)p.nh * hd;   // token stride of x and y
  const size_t xh = (size_t)b * p.S * row + (size_t)h * hd;
  const size_t bc0 = (size_t)b * p.bc_bstride;

  for (int i = tid; i < hd * LDS; i += NT) hs[i] = 0.0f;

  // each thread's rows and columns of the three products, clamped so
  // that a thread past the edge reads valid shared memory (its results
  // are never stored)
  int r8[8], c8[8], c4[4], r4[4];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    r8[a] = min(ty + 16 * a, Q - 1);
    c8[a] = min(tx + 16 * a, Q - 1);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    c4[a] = min(tx + 16 * a, hd - 1);     // y columns (d)
    r4[a] = min(ty + 16 * a, hd - 1);     // h rows (d)
  }

  for (int t0 = 0; t0 < p.S; t0 += Q) {
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = tid; idx < Q * hd; idx += NT) {
      const int i = idx / hd, d = idx % hd;
      xs[idx] = load(X, xh + (size_t)(t0 + i) * row + d);
    }
    for (int idx = tid; idx < Q * ds; idx += NT) {
      const int i = idx / ds, s = idx % ds;
      const size_t off = bc0 + (size_t)(t0 + i) * p.bc_tstride + s;
      Bs[i * LDS + s] = load(Bg, off);
      Cs[i * LDS + s] = load(Cg, off);
    }
    for (int i = tid; i < Q; i += NT)
      dts[i] = p.dt[((size_t)b * p.S + t0 + i) * p.nh + h];
    __syncthreads();

    // cum = inclusive scan of dt A, one warp: lane l owns steps [l E, l E
    // + E), E <= 4. In double: the exponents below are differences of
    // cums, and in fp32 a difference of two cums near -100 would lose
    // about 1e-5 of its exp to cancellation.
    if (tid < 32) {
      const int E = (Q + 31) / 32;
      double v[4], run = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tid * E + e;
        run += (e < E && i < Q) ? (double)dts[i] * A : 0.0;
        v[e] = run;
      }
      double tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += n;
      }
      const double base = tot - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tid * E + e;
        if (e < E && i < Q) cum[i] = base + v[e];
      }
    }
    __syncthreads();
    const double cQ = cum[Q - 1];
    for (int i = tid; i < Q; i += NT) {
      ecum[i] = expf((float)cum[i]);
      wj[i] = expf((float)(cQ - cum[i])) * dts[i];
    }

    {   // scores = (C B^T) * exp(cum_i - cum_j) * dt_j, j <= i
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
      for (int s = 0; s < ds; ++s) {
        float cv[8], bv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          cv[a] = Cs[r8[a] * LDS + s];
          bv[a] = Bs[c8[a] * LDS + s];
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          if (i < Q && j < Q)
            sc[i * LDQ + j] = j <= i
                ? acc[a][c] * expf((float)(cum[i] - cum[j])) * dts[j]
                : 0.0f;
        }
      }
    }
    __syncthreads();

    {   // y = scores @ x + exp(cum_i) (C_i . h_prev) + D x
      float acc[8][4], inter[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = inter[a][c] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        float sv[8], xv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) sv[a] = sc[r8[a] * LDQ + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[j * hd + c4[c]];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(sv[a], xv[c], acc[a][c]);
      }
      for (int s = 0; s < ds; ++s) {
        float cv[8], hv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) cv[a] = Cs[r8[a] * LDS + s];
#pragma unroll
        for (int c = 0; c < 4; ++c) hv[c] = hs[c4[c] * LDS + s];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[a][c] = fmaf(cv[a], hv[c], inter[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = tx + 16 * c;
          if (d >= hd) continue;
          float v = acc[a][c] + ecum[i] * inter[a][c];
          v += xs[i * hd + d] * Dh;
          store(Y, xh + (size_t)(t0 + i) * row + d, v);
        }
      }
    }
    __syncthreads();   // every reader of h_prev is done

    {   // h = exp(cum_Q) h_prev + sum_j w_j x_j B_j^T
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      int sc4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) sc4[c] = min(tx + 16 * c, ds - 1);
      for (int j = 0; j < Q; ++j) {
        const float w = wj[j];
        float xv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = xs[j * hd + r4[a]] * w;
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[j * LDS + sc4[c]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
      }
      const float dec = expf((float)cQ);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int d = ty + 16 * a;
        if (d >= hd) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = tx + 16 * c;
          if (s < ds) hs[d * LDS + s] = hs[d * LDS + s] * dec + acc[a][c];
        }
      }
    }
  }
  __syncthreads();
  float* H = p.hT + (size_t)bh * hd * ds;
  for (int idx = tid; idx < hd * ds; idx += NT)
    H[idx] = hs[(idx / ds) * LDS + idx % ds];
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return launch_opt_in<ssd_scan_kernel<T>>(
      p.Bb * p.nh, NT, smem_floats(QMAX, HDMAX, DSMAX) * 4,
      smem_floats(p.Q, p.hd, p.ds) * 4, p, stream);
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. Returns the CUDA
// error of the launch (0 on success); the wrapper raises on anything
// else. The wrapper has checked Q <= 128, hd <= 64, ds <= 64, S % Q == 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* A_log, const void* B,
                               const void* C, const void* D, void* y,
                               void* hT, int dtype, int Bb, int S, int nh,
                               int hd, int ds, int Q, long long bc_bstride,
                               long long bc_tstride, void* stream) {
  if (Q < 1 || Q > QMAX || hd < 1 || hd > HDMAX || ds < 1 || ds > DSMAX ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt),
           static_cast<const float*>(A_log), B, C,
           static_cast<const float*>(D), y, static_cast<float*>(hT),
           Bb, S, nh, hd, ds, Q, bc_bstride, bc_tstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
