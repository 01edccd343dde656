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
//   S is a multiple of the chunk Q <= 64 (the wrapper in ops.py pads with
//   r = k = v = logw = 0 steps, which leave s_T exact); hd <= 64.
//
// Per chunk of Q steps (padded inside the kernel to 64 with zero steps),
// with E_t = sum_{t' <= t} logw_t' per channel over the chunk (E_{-1} =
// 0), the chunked form of the recurrence:
//   y_i = (r_i e^{E_{i-1}}) h_{c-1} + sum_{j<i} A_ij v_j + (r_i.(u k_i)) v_i
//   A_ij = sum_ch r_i k_j e^{E_{i-1} - E_j}
//   s_c = sum_j (k_j e^{E_{Q-1} - E_j})^T v_j,  h_c = e^{E_{Q-1}} h_{c-1} + s_c
// (h_{-1} = s0). Every exponent is <= 0. The TPU kernel forms A from the
// two factors r e^{E_{i-1}} and k e^{-E_j}; e^{-E} overflows fp32 once a
// channel decays by more than e^{-88} within the chunk (RWKV6 decays reach
// logw = -7), and A turns to inf * 0 = NaN where the recurrence is finite.
// Here the chunk is cut into four sub-blocks of 16 steps, and a pair of
// sub-blocks I > J is rebased so that no factor exceeds 1:
//   A_IJ = (r_I e^{E_{i-1} - E_{b(I)-1}} g_IJ) (k_J e^{E_{e(J)} - E_j})^T,
//   g_IJ = e^{E_{b(I)-1} - E_{e(J)}}   (1 for J = I - 1),
// b(I) the first and e(J) the last step of a sub-block. Inside a
// sub-block no one point rebases every pair without a positive exponent:
// the sub-block's 4-step micro-blocks are rebased the same way, in fp32
// on the FMA units (7 exps a channel for a pair of micro-blocks' 16
// terms), and pairs inside a micro-block take one exp a term (none for
// neighbours, whose exponent is 0). So y is finite wherever the
// recurrence is; an underflow to 0 stands for a term below 1e-38. The
// cumsums run in double, sub-block-local (E_{i-1} - E_j inside a
// sub-block is a difference of two of them, kept as a float pair hi +
// lo); every other exponent is formed in double before it is rounded.
//
// What bounds it. The serving slice (rwkv6-3b prefill, batch 4) calls it
// at (B, S, nh, hd) = (4, 2048, 40, 64), r/k/v/y bf16 (42 MB each), logw
// fp32 (84 MB), s0 and s_T (2.6 MB each): 256,911,360 bytes, 0.0767 ms at
// 3.35 TB/s. The least work, the chunked form at chunk 4 with both
// factors fp32 (r and k meet the decays before any product), is 5.83e9
// FLOP: 0.035 ms on the bf16 tensor cores at 6 products of split terms a
// multiply-add. So the function is bound by bytes (chip_smoke.py computes
// this bound).
//
// What the design does about that. Three kernels a call, all named
// wkv_scan_*, chunk-parallel where the TPU kernel (and this kernel's
// first version, one block per (batch, head), 160 blocks on 132 SMs) walks
// the chunks in sequence: 40 x 32 x 4 = 5120 blocks at the slice, heads
// fastest in launch order, so that blocks running together read
// neighbouring columns of the same rows.
//  1. wkv_scan_state, a block per (batch, head, chunk): the cumsums, the
//     chunk's decays e^{E_{Q-1}} (hd floats) and its state s_c (hd x hd,
//     K = Q steps) on the tensor cores, into the scratch buffers.
//  2. wkv_scan_pass, per (batch, head), 4 elements of hd x hd a thread:
//     h_c = e^{E_{Q-1}} h_{c-1} + s_c from s0 (or zeros), the next 8
//     chunks' loads in flight while 8 are applied; overwrites each s_c
//     with h_{c-1}, writes s_T.
//  3. wkv_scan_chunk, a block per (batch, head, chunk): the cumsums, the
//     rebased operands and the bonus term r.(u k) (a scattered warp
//     reduction), then the off-diagonal sub-blocks of A on the tensor
//     cores (warps 0-5, one 16 x 16 tile each) and the micro-blocks of
//     the diagonal ones (every warp: lanes over channels, a scattered warp
//     reduction), then A v and (r e^{E_{i-1}}) h_{c-1} on the tensor cores
//     (h_{c-1} split into bf16 terms once, where A's operands were), y.
// The chunk states cost B nh (S / Q) hd^2 4 bytes a pass, 83.9 MB at Q =
// 64: written by 1, read and written by 2, read by 3 (336 MB, 0.100 ms at
// 3.35 TB/s, more than the function's own bytes), and 1 and 3 both read
// k, v and logw: the price of the chunk-parallel grid. Kernel 3 fits two
// blocks an SM in bf16 (113 KB of shared memory each) and is bound by
// issue and latency, not bytes. Every block of 1 and 3 prefetches into L2
// what the block a wave later will read, while it computes, so that the
// loads that start a block come from L2 (in 3, warps 6-7, while warps
// 0-5 multiply).
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). v is an
// exact bf16 operand; every fp32 factor (k e^.., r e^.. g, A, r e^{E} and
// h_{c-1}) is split into 3 bf16 terms v = v0 + v1 + v2 (24 mantissa bits,
// common.cuh), the products of terms i, j with i + j <= 2 are kept (6 for
// two fp32 factors, 3 against bf16 v), and each k step's products go into
// a zeroed accumulator that is then added to the fp32 total. fp32 v is
// split into 3 terms too. The scratch buffers are the wrapper's.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace wkv;   // NT, QM, HM, SB, NSB and the scans' helpers
constexpr int FLD = 72;   // fp32 rows read as float2 fragment pairs
constexpr int HLD = 68;   // fp32 rows read a column at a time
constexpr int LLD = 65;   // the cumsums, read a row per lane

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;     // nullptr: zeros
  void* y;
  float* sT;
  float* states;       // (B, nh, nc, hd, hd): s_c, then h_{c-1}
  float* decay;        // (B, nh, nc, hd): e^{E_{Q-1}}
  int B, S, nh, hd, Q, nc;
  int ahead;           // blocks of the launch resident at once
};

// Raw r and k rows, in elements: odd words across rows against bank
// conflicts in the diagonal loop.
template <typename T>
__host__ __device__ constexpr int raw_ld() { return sizeof(T) == 2 ? 66 : 65; }

// L2 prefetches of what the block `p.ahead` blocks later in launch order
// reads: blocks start in order, so that one starts about a wave later and
// finds its inputs in L2 (hints only: nothing waits on them). Rows of r,
// k, v of type T (those of the `n` pointers given), of logw and, with
// `state`, the (hd, hd) entering state; one per 128-byte line (rows
// aligned as the first; so are the model's), spread over threads t0.. of
// the block.
template <typename T, int N>
__device__ __forceinline__ void prefetch_ahead(const Params& p,
                                               const T* const (&src)[N],
                                               bool state, int t0) {
  const int next = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x) + p.ahead;
  if (next >= p.B * p.nc * p.nh || (int)threadIdx.x < t0) return;
  const int h = next % p.nh, ch = next / p.nh % p.nc, b = next / p.nh / p.nc;
  const size_t row = (size_t)p.nh * p.hd;
  const size_t first = ((size_t)b * p.S + (size_t)ch * p.Q) * row
      + (size_t)h * p.hd;
  auto rows = [&](const void* base, int n, int bytes, size_t stride) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base);
    const int per = (int)(((a + bytes - 1) & ~(uintptr_t)127)
                          - (a & ~(uintptr_t)127)) / 128 + 1;
    for (int idx = threadIdx.x - t0; idx < n * per; idx += NT - t0)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(
          static_cast<const char*>(base) + (size_t)(idx / per) * stride
          + idx % per * 128));
  };
#pragma unroll
  for (int n = 0; n < N; ++n)
    rows(src[n] + first, p.Q, p.hd * (int)sizeof(T), row * sizeof(T));
  rows(p.logw + first, p.Q, p.hd * 4, row * 4);
  if (state)
    rows(p.states + (((size_t)b * p.nh + h) * p.nc + ch) * p.hd * p.hd, 1,
         p.hd * p.hd * 4, 0);
}

// 1. The chunk state s_c = sum_j (k_j e^{E_{Q-1} - E_j})^T v_j of one
// (batch, head, chunk) and its decays e^{E_{Q-1}}. Warp w computes rows
// c 16 (w % 4).. and columns d 32 (w / 4).. of s_c; the A fragments of
// (k e^..)^T are read from the fp32 tile a column at a time and split
// into 3 terms in registers.
template <typename T>
__global__ void __launch_bounds__(NT, 4) wkv_scan_state(Params p) {
  constexpr int K = terms<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* tot = reinterpret_cast<double*>(smem);           // NSB x HM
  float* Kw = reinterpret_cast<float*>(tot + NSB * HM);    // QM x HLD
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Kw + QM * HLD);
  const int h = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % HM, I = tid / HM;
  const size_t row = (size_t)p.nh * p.hd;
  const size_t base = ((size_t)b * p.S + (size_t)ch * p.Q) * row
      + (size_t)h * p.hd;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + ch;
  float w[SB], kv[1][SB];
  {
    Tile<QM, T> vt(static_cast<const T*>(p.v) + base, row, p.Q, p.hd);
    const T* const src[1] = {static_cast<const T*>(p.k)};
    own_steps<T, 1>(p, base, src, w, kv);
    vt.template store_terms<K>(Vs);
  }
  double L[SB];
  local_cumsum(w, L);
  tot[I * HM + c] = L[SB - 1];
  __syncthreads();
  double after = 0.0, all = 0.0;   // the later sub-blocks', and every one
#pragma unroll
  for (int e = 0; e < NSB; ++e) {
    const double t = tot[e * HM + c];
    if (e > I) after += t;
    all += t;
  }
#pragma unroll
  for (int s = 0; s < SB; ++s)
    Kw[(I * SB + s) * HLD + c] =
        kv[0][s] * expf((float)(after + (L[SB - 1] - L[s])));
  if (I == 0 && c < p.hd) p.decay[bhc * p.hd + c] = expf((float)all);
  __syncthreads();
  {   // while this block computes, the block a wave later loads into L2
    const T* const next[2] = {static_cast<const T*>(p.k),
                              static_cast<const T*>(p.v)};
    prefetch_ahead<T, 2>(p, next, false, 0);
  }

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int c0 = (warp % 4) * 16, d0 = (warp / 4) * 32;
  if (c0 >= p.hd || d0 >= p.hd) return;
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < QM / 16; ++ks) {
    if (ks * 16 >= p.Q) break;
    float st[4][4] = {};
    // A (c, j) = Kw[j][c]: rows c0 + g (+8), cols ks 16 + 2t (+1) (+8)
    uint32_t a[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c0 + g + (q & 1) * 8;
      const int j = ks * 16 + 2 * t + (q >> 1) * 8;
      split_pack<3>(Kw[j * HLD + cc], Kw[(j + 1) * HLD + cc], a[q]);
    }
#pragma unroll
    for (int jt = K - 1; jt >= 0; --jt) {
      uint32_t bb[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        ldsm_x4_trans(bb[n2], smem_u32(Vs + jt * QM * TILE_LD
                                       + b_lane(ks * 16, d0 + 16 * n2,
                                                lane)));
      mma_terms(st, a, bb, 2 - jt);
    }
    add_to(acc, st);
  }
  float* out = p.states + bhc * p.hd * p.hd;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = c0 + g + (e >> 1) * 8, d = d0 + n * 8 + 2 * t + (e & 1);
      if (cc < p.hd && d < p.hd) out[cc * p.hd + d] = acc[n][e];
    }
}

// 2. h_c = e^{E_{Q-1},c} h_{c-1} + s_c over the chunks of one (batch,
// head) from s0 (or zeros), 4 elements of hd x hd a thread; the next 8
// chunks' loads are in flight while 8 are applied. s_c is overwritten by
// h_{c-1}, and s_T written.
__global__ void __launch_bounds__(NT) wkv_scan_pass(Params p) {
  const int n = p.hd * p.hd, e0 = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e0 >= n) return;
  const int m = min(4, n - e0);
  // hd % 4 == 0: every run of 4 is 16-byte aligned and in one row
  const bool vec = p.hd % 4 == 0;
  const size_t bh = blockIdx.y;
  float* __restrict__ st = p.states + bh * p.nc * n + e0;
  const float* __restrict__ dec = p.decay + bh * p.nc * p.hd;
  int cr[4];                         // the channel (row) of each element
  float h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cr[e] = min(e0 + e, n - 1) / p.hd;
    h[e] = p.s0 && e < m ? p.s0[bh * n + e0 + e] : 0.0f;
  }
  auto fetch = [&](int c0, float (&s)[8][4], float (&a)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in = c0 + k < p.nc;
      const float* src = st + (size_t)(in ? c0 + k : 0) * n;
      if (in && vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[k][0] = v.x, s[k][1] = v.y, s[k][2] = v.z, s[k][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[k][e] = in && e < m ? src[e] : 0.0f;
      }
      a[k] = in ? __ldg(dec + (size_t)(c0 + k) * p.hd + cr[0]) : 0.0f;
    }
  };
  float s[8][4], a[8], ns[8][4], na[8];
  fetch(0, s, a);
  for (int c0 = 0; c0 < p.nc; c0 += 8) {
    fetch(c0 + 8, ns, na);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k >= p.nc) break;
      float* dst = st + (size_t)(c0 + k) * n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = h[e] * a[k] + s[k][e];
      } else {
        const float* dk = dec + (size_t)(c0 + k) * p.hd;
        for (int e = 0; e < m; ++e) {
          dst[e] = h[e];
          h[e] = h[e] * __ldg(dk + cr[e]) + s[k][e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = na[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[k][e] = ns[k][e];
    }
  }
  for (int e = 0; e < m; ++e) p.sT[bh * n + e0 + e] = h[e];
}

// A of one full 4 x 4 micro-tile (rows i0.., columns j0.., j0 + 3 < i0)
// of a diagonal sub-block, rebased at the micro-tile's edges as the
// sub-blocks are: r_i k_j e^{E_{i-1} - E_j} = (r_i e^{E_{i-1} - E_{i0-1}}
// e^{E_{i0-1} - E_{j0+3}}) (k_j e^{E_{j0+3} - E_j}), every factor <= 1, 7
// exps a channel for 16 terms. The warp's lanes take the channels (lane,
// lane + 32), summed over the warp; lane l returns entry ((l >> 1) & 15)
// / 4, % 4.
template <typename T, int RLD>
__device__ __forceinline__ float diag_full(const T* Rr, const T* Kr,
                                           const float* Lhi,
                                           const float* Llo, int i0,
                                           int j0) {
  const int lane = threadIdx.x % 32;
  float v[16] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    float hi[4], lo[4], hj[4], lj[4], a[4], bq[4];   // hi[r]: E_{i0+r-1}
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[r] = Lhi[(i0 + r - 1) * LLD + c];
      lo[r] = Llo[(i0 + r - 1) * LLD + c];
      hj[r] = Lhi[(j0 + r) * LLD + c];
      lj[r] = Llo[(j0 + r) * LLD + c];
    }
    const float gap = __expf((hi[0] - hj[3]) + (lo[0] - lj[3]));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float fi = r ? __expf((hi[r] - hi[0]) + (lo[r] - lo[0])) : 1.0f;
      const float fj =
          r < 3 ? __expf((hj[3] - hj[r]) + (lj[3] - lj[r])) : 1.0f;
      a[r] = load(Rr, (i0 + r) * RLD + c) * fi * gap;
      bq[r] = load(Kr, (j0 + r) * RLD + c) * fj;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[r * 4 + q] = fmaf(a[r], bq[q], v[r * 4 + q]);
  }
  return warp_reduce_scatter(v);
}

// The (i, j) of the 6 strictly lower entries of a 4 x 4 micro-tile.
__device__ __forceinline__ int tri_i(int s) { return s < 1 ? 1 : s < 3 ? 2 : 3; }
__device__ __forceinline__ int tri_j(int s) {
  const int i = tri_i(s);
  return s - i * (i - 1) / 2;
}

// A of the micro-tile on the diagonal at row b (its 6 entries j < i), one
// exp a term where i - 1 > j (3 a channel; E_{i-1} - E_j = 0 for the
// neighbours), as diag_full; lane l returns entry (l >> 2) & 7 (valid
// below 6).
template <typename T, int RLD>
__device__ __forceinline__ float diag_tri(const T* Rr, const T* Kr,
                                          const float* Lhi,
                                          const float* Llo, int b) {
  const int lane = threadIdx.x % 32;
  float v[8] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    float ri[4], kj[3], hl[3], ll[3];   // rows b + 1.. of r, b.. of k, E
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ri[r + 1] = load(Rr, (b + r + 1) * RLD + c);
      kj[r] = load(Kr, (b + r) * RLD + c);
      hl[r] = Lhi[(b + r) * LLD + c];
      ll[r] = Llo[(b + r) * LLD + c];
    }
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int i = tri_i(s), j = tri_j(s);
      const float e = i - 1 > j
          ? __expf((hl[i - 1] - hl[j]) + (ll[i - 1] - ll[j])) : 1.0f;
      v[s] = fmaf(ri[i] * kj[j], e, v[s]);
    }
  }
  return warp_reduce_scatter(v);
}

// 3. y of one (batch, head, chunk).
template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv_scan_chunk(Params p) {
  constexpr int K = terms<T>(), RLD = raw_ld<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* tot = reinterpret_cast<double*>(smem);           // NSB x HM
  float* Lhi = reinterpret_cast<float*>(tot + NSB * HM);   // QM x LLD
  float* Llo = Lhi + QM * LLD;     // the sub-block cumsums as hi + lo
  float* As = Lhi;                 // QM x FLD: A, once the cumsums are read
  float* RR = Llo + QM * LLD;      // QM x FLD: r e^{E_{i-1} - E_{b-1}}
  float* Hs = RR + QM * FLD;       // HM x HLD: h_{c-1}
  float* G = Hs + HM * HLD;        // 2 x HM: g of (2, 0) and of (3, 1)
  float* Eb = G + 2 * HM;          // NSB x HM: e^{E_{b(I)-1}}
  float* bonus = Eb + NSB * HM;    // 2 x QM: r.(u k), a half of hd each
  float* KK = bonus + 2 * QM;      // (QM - SB) x FLD: k e^{E_e - E_j}
  T* Rr = reinterpret_cast<T*>(KK + (QM - SB) * FLD);   // QM x RLD: r
  T* Kr = Rr + QM * RLD;                                // QM x RLD: k
  // h_{c-1} as 3 bf16 terms, once KK, Rr and Kr are read
  __nv_bfloat16* Ht = reinterpret_cast<__nv_bfloat16*>(KK);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Kr + QM * RLD);
  const int h = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % HM, I = tid / HM;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)p.nh * p.hd;
  const size_t base = ((size_t)b * p.S + (size_t)ch * p.Q) * row
      + (size_t)h * p.hd;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + ch;
  {   // every load of the block in flight before any is used
    Tile<QM, T> vt(static_cast<const T*>(p.v) + base, row, p.Q, p.hd);
    Tile<HM, float> ht(p.states + bhc * p.hd * p.hd, p.hd, p.hd, p.hd);
    const T* const src[2] = {static_cast<const T*>(p.r),
                             static_cast<const T*>(p.k)};
    float w[SB], rk[2][SB];
    own_steps<T, 2>(p, base, src, w, rk);
    const float u = c < p.hd ? p.u[(size_t)h * p.hd + c] : 0.0f;
    vt.template store_terms<K>(Vs);
    ht.store_f32(Hs, HLD);
    double L[SB];
    local_cumsum(w, L);
    tot[I * HM + c] = L[SB - 1];
    if (I == 1 || I == 2)          // g_20 = e^{E_1}, g_31 = e^{E_2}
      G[(I - 1) * HM + c] = expf((float)L[SB - 1]);
    float bo[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int i = I * SB + s;
      store(Rr, i * RLD + c, rk[0][s]);   // exact: r and k are T values
      store(Kr, i * RLD + c, rk[1][s]);
      const float hi = (float)L[s];
      Lhi[i * LLD + c] = hi;
      Llo[i * LLD + c] = (float)(L[s] - (double)hi);
      RR[i * FLD + c] = s ? rk[0][s] * expf((float)L[s - 1]) : rk[0][s];
      if (I < NSB - 1)
        KK[i * FLD + c] = rk[1][s] * expf((float)(L[SB - 1] - L[s]));
      bo[s] = fmaf(rk[0][s], u * rk[1][s], 0.0f);
    }
    // r.(u k) over this warp's 32 channels; lane 2 s holds step s's
    const float part = warp_reduce_scatter(bo);
    if (!(lane & 1)) bonus[(warp & 1) * QM + I * SB + lane / 2] = part;
  }
  __syncthreads();

  if (warp >= 6) {   // while warps 0-5 multiply, the block a wave
                     // later loads into L2
    const T* const next[3] = {static_cast<const T*>(p.r),
                              static_cast<const T*>(p.k),
                              static_cast<const T*>(p.v)};
    prefetch_ahead<T, 3>(p, next, true, 6 * 32);
  }
  // e^{E_{b(I)-1}} for r e^{E_{i-1}} = RR e^{E_{b-1}}
  {
    double pre = 0.0;
    for (int e = 0; e < I; ++e) pre += tot[e * HM + c];
    Eb[I * HM + c] = expf((float)pre);
  }
  // A, off the diagonal: warp w < 6 computes the 16 x 16 tile of sub-block
  // pair (I, J) = (1, 0), (2, 1), (3, 2), (2, 0), (3, 0), (3, 1), K = hd.
  float at[2][4] = {};
  const int tI = warp < 3 ? warp + 1 : warp == 3 ? 2 : 3;
  const int tJ = warp < 3 ? warp : warp == 5 ? 1 : 0;
  if (warp < 6) {
#pragma unroll
    for (int ks = 0; ks < HM / 16; ++ks) {
      if (ks * 16 >= p.hd) break;
      float st[2][4] = {};
      uint32_t a[4][3], bt[2][2][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tI * 16 + g + (q & 1) * 8;
        const int cc = ks * 16 + 2 * t + (q >> 1) * 8;
        float2 x = *reinterpret_cast<const float2*>(RR + i * FLD + cc);
        if (warp >= 3) {   // g of the sub-blocks strictly between
          const float2 g20 = *reinterpret_cast<const float2*>(G + cc);
          const float2 g31 = *reinterpret_cast<const float2*>(G + HM + cc);
          const float2 gg = warp == 3 ? g20 : warp == 5 ? g31
              : make_float2(g20.x * g31.x, g20.y * g31.y);
          x.x *= gg.x;
          x.y *= gg.y;
        }
        split_pack<3>(x.x, x.y, a[q]);
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = tJ * 16 + nn * 8 + g;
          const float2 y = *reinterpret_cast<const float2*>(
              KK + j * FLD + ks * 16 + 2 * t + hh * 8);
          split_pack<3>(y.x, y.y, bt[nn][hh]);
        }
#pragma unroll
      for (int jj = 2; jj >= 0; --jj)
#pragma unroll
        for (int ii = 2 - jj; ii >= 0; --ii) {
          const uint32_t ai[4] = {a[0][ii], a[1][ii], a[2][ii], a[3][ii]};
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
            mma_bf16(st[nn], ai, bt[nn][0][jj], bt[nn][1][jj]);
        }
      add_to(at, st);
    }
  }
  // A inside the sub-blocks, as 4 x 4 micro-tiles: warp w takes the full
  // ones w, w + 8, w + 16 of the 24 and the diagonal ones w, w + 8 of 16
  float df[3], dt[2];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int ft = warp + 8 * m, blk = ft / 6, mi = tri_i(ft % 6);
    df[m] = diag_full<T, RLD>(Rr, Kr, Lhi, Llo, blk * SB + 4 * mi,
                              blk * SB + 4 * tri_j(ft % 6));
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int dq = warp + 8 * m;
    dt[m] = diag_tri<T, RLD>(Rr, Kr, Lhi, Llo, (dq / 4) * SB + 4 * (dq % 4));
  }
  __syncthreads();   // every read of the cumsums, KK, r and k is done
  if (warp < 6) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = tI * 16 + g + (e >> 1) * 8;
        const int j = tJ * 16 + nn * 8 + 2 * t;
        *reinterpret_cast<float2*>(As + i * FLD + j) =
            make_float2(at[nn][e], at[nn][e + 1]);
      }
  }
  if (!(lane & 1)) {
    const int s = (lane >> 1) & 15;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int ft = warp + 8 * m, blk = ft / 6;
      const int i = blk * SB + 4 * tri_i(ft % 6) + s / 4;
      As[i * FLD + blk * SB + 4 * tri_j(ft % 6) + s % 4] = df[m];
    }
  }
  if (!(lane & 3) && lane < 24) {
    const int s = lane >> 2;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int dq = warp + 8 * m, b0 = (dq / 4) * SB + 4 * (dq % 4);
      As[(b0 + tri_i(s)) * FLD + b0 + tri_j(s)] = dt[m];
    }
  }
  {   // zeros on and above the diagonal of the diagonal sub-blocks
    const int il = tid / SB, jl = tid % SB;
    if (jl >= il)
#pragma unroll
      for (int blk = 0; blk < NSB; ++blk)
        As[(blk * SB + il) * FLD + blk * SB + jl] = 0.0f;
  }
  {   // h_{c-1} as 3 bf16 terms for ldmatrix
#pragma unroll
    for (int k = 0; k < HM * HM / 4 / NT; ++k) {
      const int idx = (tid + k * NT) * 4, i = idx / HM, j = idx % HM;
      const float4 x = *reinterpret_cast<const float4*>(Hs + i * HLD + j);
      uint32_t lo[3], hi[3];
      split_pack<3>(x.x, x.y, lo);
      split_pack<3>(x.z, x.w, hi);
#pragma unroll
      for (int e = 0; e < 3; ++e)
        *reinterpret_cast<uint2*>(Ht + e * HM * TILE_LD + i * TILE_LD + j) =
            make_uint2(lo[e], hi[e]);
    }
  }
  __syncthreads();

  // y: warp w owns rows 16 (w % 4).. and columns 32 (w / 4).. of y
  const int rb = warp % 4, n0 = (warp / 4) * 32;
  if (n0 >= p.hd || rb * 16 >= p.Q) return;
  float yi[4][4] = {}, ye[4][4] = {};
  // A v, k steps 0..rb: A (3 terms), v (K terms)
#pragma unroll
  for (int ks = 0; ks < NSB; ++ks) {
    if (ks > rb) break;
    float st[4][4] = {};
    uint32_t a[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = rb * 16 + g + (q & 1) * 8;
      const int j = ks * 16 + 2 * t + (q >> 1) * 8;
      const float2 x = *reinterpret_cast<const float2*>(As + i * FLD + j);
      split_pack<3>(x.x, x.y, a[q]);
    }
#pragma unroll
    for (int jt = K - 1; jt >= 0; --jt) {
      uint32_t bb[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        ldsm_x4_trans(bb[n2], smem_u32(Vs + jt * QM * TILE_LD
                                       + b_lane(ks * 16, n0 + 16 * n2,
                                                lane)));
      mma_terms(st, a, bb, 2 - jt);
    }
    add_to(yi, st);
  }
  // (r e^{E_{i-1}}) h_{c-1}, k steps over channels: both 3 terms
#pragma unroll
  for (int ks = 0; ks < HM / 16; ++ks) {
    if (ks * 16 >= p.hd) break;
    float st[4][4] = {};
    uint32_t a[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = rb * 16 + g + (q & 1) * 8;
      const int cc = ks * 16 + 2 * t + (q >> 1) * 8;
      const float2 x = *reinterpret_cast<const float2*>(RR + i * FLD + cc);
      const float2 e = *reinterpret_cast<const float2*>(Eb + rb * HM + cc);
      split_pack<3>(x.x * e.x, x.y * e.y, a[q]);
    }
#pragma unroll
    for (int jt = 2; jt >= 0; --jt) {
      uint32_t bb[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        ldsm_x4_trans(bb[n2], smem_u32(Ht + jt * HM * TILE_LD
                                       + b_lane(ks * 16, n0 + 16 * n2,
                                                lane)));
      mma_terms(st, a, bb, 2 - jt);
    }
    add_to(ye, st);
  }
  T* Y = static_cast<T*>(p.y);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rb * 16 + g + (e >> 1) * 8;
      const int d = n0 + n * 8 + 2 * t + (e & 1);
      if (i >= p.Q || d >= p.hd) continue;
      float v = 0.0f;     // v from its staged terms (v itself when bf16)
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        v += __bfloat162float(Vs[k * QM * TILE_LD + i * TILE_LD + d]);
      store(Y, base + (size_t)i * row + d,
            yi[n][e] + (bonus[i] + bonus[QM + i]) * v + ye[n][e]);
    }
}

constexpr size_t state_smem(int K) {
  return NSB * HM * 8 + QM * HLD * 4 + (size_t)K * QM * TILE_LD * 2;
}
template <typename T>
constexpr size_t chunk_smem() {
  return NSB * HM * 8 + 2 * QM * LLD * 4 + QM * FLD * 4 + HM * HLD * 4
      + (2 * HM + NSB * HM + 2 * QM) * 4 + (QM - SB) * FLD * 4
      + 2 * (size_t)QM * raw_ld<T>() * sizeof(T)
      + (size_t)terms<T>() * QM * TILE_LD * 2;
}
static_assert(chunk_smem<__nv_bfloat16>() <= 113 * 1024,
              "two wkv_scan_chunk blocks an SM in bf16");
static_assert((QM - SB) * FLD * 4 + 2 * QM * raw_ld<__nv_bfloat16>() * 2
                  >= 3 * HM * TILE_LD * 2,
              "h_{c-1}'s bf16 terms fit where KK, r and k were");

// Blocks of Kernel resident on the device at once with `smem` bytes of
// shared memory each (queried once a kernel).
template <auto Kernel>
int resident(size_t smem) {
  static const int n = [smem] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, Kernel, NT, smem);
    return sms * (per > 0 ? per : 1);
  }();
  return n;
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int K = terms<T>();
  p.ahead = resident<wkv_scan_state<T>>(state_smem(K));
  cudaError_t e = launch_opt_in<wkv_scan_state<T>>(
      dim3(p.nh, p.nc, p.B), NT, state_smem(K), state_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  wkv_scan_pass<<<dim3((p.hd * p.hd + 4 * NT - 1) / (4 * NT), p.B * p.nh),
                  NT, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  p.ahead = resident<wkv_scan_chunk<T>>(chunk_smem<T>());
  return launch_opt_in<wkv_scan_chunk<T>>(
      dim3(p.nh, p.nc, p.B), NT, chunk_smem<T>(), chunk_smem<T>(), p,
      stream);
}

}  // namespace

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16; s0 may be null.
// states and decay are the wrapper's fp32 scratch of (B, nh, S / Q, hd,
// hd) and (B, nh, S / Q, hd) floats. Returns the first CUDA error of the
// three launches (0 on success); the wrapper raises on anything else. The
// wrapper has checked Q <= 64, hd <= 64, S % Q == 0.
extern "C" int wkv_scan_launch(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* s0, void* y, void* sT,
                               void* states, void* decay, int dtype, int B,
                               int S, int nh, int hd, int Q, void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(s0), y,
           static_cast<float*>(sT), static_cast<float*>(states),
           static_cast<float*>(decay), B, S, nh, hd, Q, S / Q, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
