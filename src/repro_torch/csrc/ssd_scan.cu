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
//   A = -exp(A_log). S is a multiple of the chunk Q <= 128 (the wrapper in
//   ops.py pads with dt = 0 steps, which leave h_T exact).
//
// Per chunk c of Q steps, with cum = cumsum(dt A) over the chunk (every
// step's log decay is <= 0, so cum decreases and each exponent below is
// <= 0), the SSD decomposition of Mamba2:
//   scores[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j      for j <= i
//   s_c   = sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T            (chunk state)
//   h_c   = exp(cum_Q) h_{c-1} + s_c                         (state passing)
//   y     = scores @ x + exp(cum_i) (C_i . h_{c-1}) + D x     (chunk output)
// cum is summed and differenced in double: in fp32 the difference of two
// cums near -100 keeps only about 1e-5 of its exp.
//
// What bounds it. The serving slice (zamba2-7b prefill, batch 4) calls
// it at (Bb, S, nh, hd, ds) = (4, 2048, 112, 64, 64), x/B/C bf16: x and y
// (117 MB each), B and C (1 MB each), dt (3.7 MB) and h_T (7.3 MB) moved
// once take 0.074 ms at 3.35 TB/s. The least arithmetic is the chunked
// form at chunk 8, 1.60e10 multiply-add FLOP with fp32 factors; on the
// bf16 tensor cores, with each fp32 factor split into 3 bf16 terms
// against the exact bf16 operand, 4.8e10 FLOP, 0.049 ms at 989 TFLOP/s.
// So the function is bound by bytes (chip_smoke.py computes this bound).
//
// What the design does about that. Four kernels a call, every one named
// ssd_scan_*, chunk-parallel where the TPU kernel walks its chunks in
// sequence (448 blocks of the old design become 448 x S / Q):
//  1. ssd_scan_cb, a block per (batch, chunk): C B^T once for all heads,
//     the causal half only (16 x 16 tiles on or below the diagonal), on
//     the bf16 tensor cores, into a (Bb, S / Q, 128, 128) fp32 buffer (4
//     MB at the slice, read from L2 by every head's block). A first pass
//     rather than each head's block: the product is shared by 112 heads.
//  2. ssd_scan_state, a block per (batch, head, chunk): the chunk state
//     s_c (hd x ds, K = Q steps) on the tensor cores, into a (Bb, nh, S /
//     Q, hd, ds) fp32 buffer, and the chunk's decay exp(cum_Q).
//  3. ssd_scan_pass, per (batch, head): the short sequential pass over
//     the S / Q chunks, elementwise over hd x ds, which overwrites each
//     s_c with the state entering its chunk, h_{c-1}, and writes h_T.
//  4. ssd_scan_chunk, a block per (batch, head, chunk): the causal half of
//     scores @ x and C h_{c-1}^T on the tensor cores, then y.
// The chunk states cost Bb nh (S / Q) hd ds 4 bytes a pass: 117 MB at Q =
// 128, written by 2, read and written by 3 and read by 4 (470 MB in all,
// 0.140 ms at 3.35 TB/s, twice the function's own bytes): the price of
// the chunk-parallel grid. Q = 128 keeps that price at half of Q = 64's
// while the score tile stays within a block's registers; fusing 3 into 4
// would put the sequential pass back in front of every chunk's output.
// Kernels 2 and 4 are latency-bound, so their launch bounds ask for 4
// and 3 blocks an SM (64 and 85 registers a thread): more warps in
// flight gain more than the few registers spilled cost (measured on the
// H100).
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). x, B and C
// are exact bf16 operands; every fp32 factor (the decayed scores, w x and
// h_{c-1}) is split into 3 bf16 terms v = v0 + v1 + v2 (24 mantissa
// bits), and the products of the terms are summed, so no score or
// carried state is rounded to bf16. fp32 inputs split x, B and C into 3
// terms too and keep the products of terms i, j with i + j <= 2. The
// scratch buffers are allocated by the wrapper.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads a block: 8 warps
constexpr int QM = 128, HM = 64, DM = 64;  // chunk, hd and ds maxima
constexpr int LD = TILE_LD;              // bf16 row of 64 + 8

struct Params {
  const void* x;
  const float* dt;
  const float* A_log;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* hT;
  float* cb;       // (Bb, nc, QM, QM): C B^T, causal 16 x 16 tiles
  float* states;   // (Bb, nh, nc, hd, ds): s_c, then h_{c-1}
  float* decay;    // (Bb, nh, nc): exp(cum_Q)
  int Bb, S, nh, hd, ds, Q, nc;
  long long bc_bstride, bc_tstride;   // B and C strides, elements
};

// cum[i] = sum_{t <= i} dt_t A over the chunk's QM (zero-padded) steps,
// in double, by warp 0: lane l owns steps [4 l, 4 l + 4).
__device__ void chunk_cumsum(double* cum, const float* dts, float A) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  double v[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += (double)dts[tid * 4 + e] * A;
    v[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, tot, off);
    if (tid >= off) tot += n;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) cum[tid * 4 + e] = tot - run + v[e];
}

__device__ void load_dt(float* dts, const Params& p, int b, int h, int t0) {
  for (int i = threadIdx.x; i < QM; i += NT)
    dts[i] = i < p.Q ? p.dt[((size_t)b * p.S + t0 + i) * p.nh + h] : 0.0f;
}

// exp(cum_i - cum_j) for j <= i (an exponent <= 0), with cum as the float
// pair hi + lo: hi_i - hi_j + (lo_i - lo_j) keeps the difference to a few
// ulps of itself, so exp is accurate to about 2e-8 absolute, without
// double arithmetic for each score.
__device__ __forceinline__ float decay(const float* hi, const float* lo,
                                       int i, int j) {
  return __expf((hi[i] - hi[j]) + (lo[i] - lo[j]));
}

// 1. C B^T of one (batch, chunk), 16 x 16 tiles on or below the diagonal.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_cb(Params p) {
  constexpr int K = terms<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Cs + K * QM * LD;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * p.Q;
  const size_t bc0 = (size_t)b * p.bc_bstride + (size_t)t0 * p.bc_tstride;
  {
    Tile<QM, T> ct(static_cast<const T*>(p.C) + bc0, p.bc_tstride, p.Q, p.ds);
    Tile<QM, T> bt(static_cast<const T*>(p.B) + bc0, p.bc_tstride, p.Q, p.ds);
    ct.template store_terms<K>(Cs);
    bt.template store_terms<K>(Bs);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nrb = (p.Q + 15) / 16, ksteps = (p.ds + 15) / 16;
  float* out = p.cb + ((size_t)b * p.nc + c) * QM * QM;
  for (int tile = warp; tile < nrb * (nrb + 1) / 2; tile += NT / 32) {
    int rb = 0;
    while ((rb + 1) * (rb + 2) / 2 <= tile) ++rb;
    const int cb = tile - rb * (rb + 1) / 2;
    float acc[2][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      float st[2][4] = {};
      uint32_t a[K][4], bt[K][4];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ldsm_x4(a[k], smem_u32(Cs + k * QM * LD
                               + a_lane(rb * 16, ks * 16, lane)));
        ldsm_x4(bt[k], smem_u32(Bs + k * QM * LD
                                + bt_lane(cb * 16, ks * 16, lane)));
      }
#pragma unroll
      for (int i = K - 1; i >= 0; --i)
#pragma unroll
        for (int j = K - 1 - i; j >= 0; --j) {
          mma_bf16(st[0], a[i], bt[j][0], bt[j][1]);
          mma_bf16(st[1], a[i], bt[j][2], bt[j][3]);
        }
      add_to(acc, st);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = rb * 16 + g + (e >> 1) * 8;
        const int j = cb * 16 + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + i * QM + j) =
            make_float2(acc[n][e], acc[n][e + 1]);
      }
  }
}

// 2. The chunk state s_c = sum_j w_j x_j B_j^T, w_j = exp(cum_Q - cum_j)
// dt_j, of one (batch, head, chunk), and the chunk's decay exp(cum_Q).
// Warp w computes hd rows 16 (w % 4).. and ds columns 32 (w / 4)..; the
// A fragments of x^T come from the staged x through ldmatrix.trans and
// are scaled by w and split into 3 terms in registers.
template <typename T>
__global__ void __launch_bounds__(NT, 4) ssd_scan_state(Params p) {
  constexpr int K = terms<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + QM);
  float* w = dts + QM;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(w + QM);
  __nv_bfloat16* Xs = Bs + K * QM * LD;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int tid = threadIdx.x;
  const float A = -expf(p.A_log[h]);
  {
    Tile<QM, T> bt(static_cast<const T*>(p.B) + (size_t)b * p.bc_bstride
                   + (size_t)t0 * p.bc_tstride, p.bc_tstride, p.Q, p.ds);
    Tile<QM, T> xt(static_cast<const T*>(p.x)
                   + ((size_t)b * p.S + t0) * p.nh * p.hd + (size_t)h * p.hd,
                   (size_t)p.nh * p.hd, p.Q, p.hd);
    load_dt(dts, p, b, h, t0);
    bt.template store_terms<K>(Bs);
    xt.template store_terms<K>(Xs);
  }
  __syncthreads();
  chunk_cumsum(cum, dts, A);
  __syncthreads();
  const double cQ = cum[QM - 1];
  for (int j = tid; j < QM; j += NT) w[j] = expf((float)(cQ - cum[j])) * dts[j];
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + c;
  if (tid == 0) p.decay[bhc] = expf((float)cQ);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int d0 = (warp % 4) * 16, s0 = (warp / 4) * 32;
  if (d0 >= p.hd || s0 >= p.ds) return;
  float acc[4][4] = {};
  for (int ks = 0; ks < (p.Q + 15) / 16; ++ks) {
    float st[4][4] = {};
    // A (d, j) = w_j x_j[d]: rows d0 + g (+8), cols ks 16 + 2t (+8)
    float xa[4][2] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t r[4];
      ldsm_x4_trans(r, smem_u32(Xs + k * QM * LD
                                + bt_lane(ks * 16, d0, lane)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
        xa[q][0] += __low2float(v);
        xa[q][1] += __high2float(v);
      }
    }
    uint32_t a[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = ks * 16 + 2 * t + (q >> 1) * 8;
      split_pack<3>(w[j] * xa[q][0], w[j + 1] * xa[q][1], a[q]);
    }
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      uint32_t bb[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        ldsm_x4_trans(bb[n2], smem_u32(Bs + j * QM * LD
                                       + b_lane(ks * 16, s0 + 16 * n2, lane)));
      mma_terms(st, a, bb, 2 - j);
    }
    add_to(acc, st);
  }
  float* out = p.states + bhc * p.hd * p.ds;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + g + (e >> 1) * 8, s = s0 + n * 8 + 2 * t + (e & 1);
      if (d < p.hd && s < p.ds) out[d * p.ds + s] = acc[n][e];
    }
}

// 3. h_c = exp(cum_Q,c) h_{c-1} + s_c over the chunks of one (batch,
// head), 4 elements of hd x ds a thread with 8 chunks' loads in flight;
// s_c is overwritten by h_{c-1}.
__global__ void __launch_bounds__(NT) ssd_scan_pass(Params p) {
  const int n = p.hd * p.ds, e0 = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e0 >= n) return;
  const int m = min(4, n - e0);
  const bool vec = n % 4 == 0;       // every run of 4 is 16-byte aligned
  const size_t bh = blockIdx.y;
  float* __restrict__ st = p.states + bh * p.nc * n + e0;
  const float* __restrict__ dec = p.decay + bh * p.nc;
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < p.nc; c0 += 8) {
    float s[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float* src = st + (size_t)(c0 + k) * n;
      if (c0 + k < p.nc && vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[k][0] = v.x, s[k][1] = v.y, s[k][2] = v.z, s[k][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[k][e] = c0 + k < p.nc && e < m ? src[e] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k >= p.nc) break;
      float* dst = st + (size_t)(c0 + k) * n;
      const float a = __ldg(dec + c0 + k);
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
        for (int e = 0; e < m; ++e) dst[e] = h[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = h[e] * a + s[k][e];
    }
  }
  for (int e = 0; e < m; ++e) p.hT[bh * n + e0 + e] = h[e];
}

// 4. y of one (batch, head, chunk): the causal half of scores @ x, plus
// exp(cum_i) (C_i . h_{c-1}), plus D x. Warp w owns two units of 16 rows
// x 32 columns of y, rows 16 w with columns 0..31 and rows 16 (7 - w)
// with columns 32..63, so every warp does 9 of the 36 causal k steps.
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_scan_chunk(Params p) {
  constexpr int K = terms<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + QM);
  float* ecum = dts + QM;
  float* chi = ecum + QM;   // cum as the float pair chi + clo
  float* clo = chi + QM;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(clo + QM);
  __nv_bfloat16* Cs = Xs + K * QM * LD;
  __nv_bfloat16* Hs = Cs + K * QM * LD;                 // 3 terms, HM x LD
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int tid = threadIdx.x;
  const float A = -expf(p.A_log[h]);
  const size_t row = (size_t)p.nh * p.hd;               // token stride of x
  const size_t xh = ((size_t)b * p.S + t0) * row + (size_t)h * p.hd;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + c;
  const T* X = static_cast<const T*>(p.x);
  {   // every load of the block in flight before any is used
    Tile<QM, T> xt(X + xh, row, p.Q, p.hd);
    Tile<QM, T> ct(static_cast<const T*>(p.C) + (size_t)b * p.bc_bstride
                   + (size_t)t0 * p.bc_tstride, p.bc_tstride, p.Q, p.ds);
    Tile<HM, float> ht(p.states + bhc * p.hd * p.ds, p.ds, p.hd, p.ds);
    load_dt(dts, p, b, h, t0);
    xt.template store_terms<K>(Xs);
    ct.template store_terms<K>(Cs);
    ht.template store_terms<3>(Hs);
  }
  __syncthreads();
  chunk_cumsum(cum, dts, A);
  __syncthreads();
  for (int i = tid; i < QM; i += NT) {
    ecum[i] = expf((float)cum[i]);
    chi[i] = (float)cum[i];
    clo[i] = (float)(cum[i] - (double)chi[i]);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int nrb = (p.Q + 15) / 16, dsteps = (p.ds + 15) / 16;
  const float* CB = p.cb + ((size_t)b * p.nc + c) * QM * QM;
  const float Dh = p.D[h];
  T* Y = static_cast<T*>(p.y);
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    const int rb = u == 0 ? warp : 7 - warp, n0 = u * 32;
    if (rb >= nrb || n0 >= p.hd) continue;
    float yi[4][4] = {}, ye[4][4] = {};
    // scores @ x, k steps 0..rb: A = scores (3 terms), B = x (K terms)
    // this thread's C B^T entries of k step ks, loaded one step ahead
    auto fetch = [&](int ks, float2 (&v)[4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = __ldg(reinterpret_cast<const float2*>(
            CB + (rb * 16 + g + (r & 1) * 8) * QM + ks * 16 + 2 * t
            + (r >> 1) * 8));
    };
    float2 cbv[4], nxt[4];
    fetch(0, cbv);
    for (int ks = 0; ks <= rb; ++ks) {
      if (ks < rb) fetch(ks + 1, nxt);
      float st[4][4] = {};
      uint32_t a[4][3];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = rb * 16 + g + (r & 1) * 8;
        const int j = ks * 16 + 2 * t + (r >> 1) * 8;
        const float s0 = j <= i
            ? cbv[r].x * decay(chi, clo, i, j) * dts[j] : 0.0f;
        const float s1 = j + 1 <= i
            ? cbv[r].y * decay(chi, clo, i, j + 1) * dts[j + 1] : 0.0f;
        split_pack<3>(s0, s1, a[r]);
      }
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        uint32_t bb[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[n2], smem_u32(Xs + j * QM * LD
                                         + b_lane(ks * 16, n0 + 16 * n2,
                                                  lane)));
        mma_terms(st, a, bb, 2 - j);
      }
      add_to(yi, st);
#pragma unroll
      for (int r = 0; r < 4; ++r) cbv[r] = nxt[r];
    }
    // C h_{c-1}^T: A = C (K terms), B^T = h (3 terms, rows d, cols s)
    for (int ks = 0; ks < dsteps; ++ks) {
      float st[4][4] = {};
      uint32_t a[K][4];
#pragma unroll
      for (int i = 0; i < K; ++i)
        ldsm_x4(a[i], smem_u32(Cs + i * QM * LD
                               + a_lane(rb * 16, ks * 16, lane)));
#pragma unroll
      for (int j = 2; j >= 0; --j) {
        uint32_t bt[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4(bt[n2], smem_u32(Hs + j * HM * LD
                                   + bt_lane(n0 + 16 * n2, ks * 16, lane)));
#pragma unroll
        for (int i = min(K - 1, 2 - j); i >= 0; --i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(st[n], a[i], bt[n / 2][(n % 2) * 2],
                     bt[n / 2][(n % 2) * 2 + 1]);
      }
      add_to(ye, st);
    }
    // D x from the staged terms of x (x itself when x is bf16)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb * 16 + g + (e >> 1) * 8;
        const int d = n0 + n * 8 + 2 * t + (e & 1);
        if (i >= p.Q || d >= p.hd) continue;
        float x = 0.0f;
#pragma unroll
        for (int k = K - 1; k >= 0; --k)
          x += __bfloat162float(Xs[k * QM * LD + i * LD + d]);
        store(Y, xh + (size_t)i * row + d,
              yi[n][e] + ecum[i] * ye[n][e] + x * Dh);
      }
  }
}

constexpr size_t cb_smem(int K) { return 2 * (size_t)K * QM * LD * 2; }
constexpr size_t state_smem(int K) {
  return QM * 8 + 2 * QM * 4 + 2 * (size_t)K * QM * LD * 2;
}
constexpr size_t chunk_smem(int K) {
  return QM * 8 + 4 * QM * 4 + 2 * (size_t)K * QM * LD * 2
      + 3 * (size_t)HM * LD * 2;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int K = terms<T>();
  cudaError_t e = launch_opt_in<ssd_scan_cb<T>>(
      dim3(p.nc, p.Bb), NT, cb_smem(K), cb_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_state<T>>(
      dim3(p.nc, p.nh, p.Bb), NT, state_smem(K), state_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  ssd_scan_pass<<<dim3((p.hd * p.ds + 4 * NT - 1) / (4 * NT), p.Bb * p.nh),
                  NT, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_opt_in<ssd_scan_chunk<T>>(
      dim3(p.nc, p.nh, p.Bb), NT, chunk_smem(K), chunk_smem(K), p, stream);
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. cb, states and
// decay are the wrapper's fp32 scratch of (Bb, S / Q, 128, 128), (Bb, nh,
// S / Q, hd, ds) and (Bb, nh, S / Q) floats. Returns the first CUDA error
// of the four launches (0 on success); the wrapper raises on anything
// else. The wrapper has checked Q <= 128, hd <= 64, ds <= 64, S % Q == 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* A_log, const void* B,
                               const void* C, const void* D, void* y,
                               void* hT, void* cb, void* states, void* decay,
                               int dtype, int Bb, int S, int nh, int hd,
                               int ds, int Q, long long bc_bstride,
                               long long bc_tstride, void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || ds < 1 || ds > DM ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt),
           static_cast<const float*>(A_log), B, C,
           static_cast<const float*>(D), y, static_cast<float*>(hT),
           static_cast<float*>(cb), static_cast<float*>(states),
           static_cast<float*>(decay), Bb, S, nh, hd, ds, Q, S / Q,
           bc_bstride, bc_tstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
