// Backward of the RWKV6 WKV scan (csrc/wkv_scan.cu) for sm_90a.
//
// No TPU kernel: the reference differentiates its jnp chunked scan
// `wkv_chunk_scan` (src/repro/models/rwkv.py:64) with jax.grad. This is
// the backward of the `torch.autograd.Function` in
// kernels/wkv_scan/ops.py, whose forward is the wkv_scan kernel. Its
// oracle is `ref.py::wkv_scan_bwd_ref`. With the forward
//   y_t = S_t^T r_t + (r_t . (u k_t)) v_t,
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T,   w_t = e^{logw_t},
// the gradients of sum(y dy) + sum(s_T d s_T) (d s_T zeros when s_T
// carries no gradient).
//
// Inputs: r, k, v, dy (B, S, nh, hd) of one dtype (fp32 or bf16), logw
// (B, S, nh, hd) and u (nh, hd) fp32, the forward's chunk scratch
// `states` (B, nh, S / Q, hd, hd) fp32, which its state pass leaves
// holding h_{c-1}, the state entering chunk c; d s_T (B, nh, hd, hd) fp32
// or null. Outputs: dr, dk, dv of r's dtype; dlogw fp32 (B, S, nh, hd);
// du (nh, hd) fp32; ds0 (B, nh, hd, hd) fp32 or null. S is a multiple of
// the chunk Q <= 64 (ops.py pads), hd <= 64. Scratch, the wrapper's:
// dstate (B, nh, S / Q, hd, hd), decay (B, nh, S / Q, hd) and du partials
// (B, S / Q, nh, hd), all fp32; the kernels allocate nothing.
//
// The chunked form. Per chunk of Q steps (padded inside to 64 with zero
// steps), E_t = sum_{t' <= t} logw_t' over the chunk (E_{-1} = 0), h_{c-1}
// the state entering it and dH_c the gradient of the state after it (d s_T
// for the last chunk), M_ij = dy_i . v_j and A_ij = sum_ch r_i k_j
// e^{E_{i-1} - E_j} the forward's matrix:
//   dH_{c-1} = e^{E_{Q-1}} dH_c + ds_c,  ds_c = sum_i (r_i e^{E_{i-1}})^T dy_i,
//   ds0 = dH_{-1};
//   dr_i = e^{E_{i-1}} (h_{c-1} dy_i) + sum_{j<i} M_ij k_j e^{E_{i-1}-E_j}
//          + u k_i M_ii
//   dk_j = e^{E_{Q-1}-E_j} (dH_c v_j) + sum_{i>j} M_ij r_i e^{E_{i-1}-E_j}
//          + u r_j M_jj
//   dv_j = dH_c^T (k_j e^{E_{Q-1}-E_j}) + sum_{i>j} A_ij dy_i
//          + (r_j . u k_j) dy_j
//   du = sum over batch and time of r k M_ii.
// dlogw_t sums the terms whose exponent holds logw_t. A pair i > j counts
// for j < t <= i - 1, so its term x is added as +x at t = i - 1 and -x at
// t = j and suffix-summed; the pairs of neighbours (i = j + 1, exponent 0
// whatever the decay) count nowhere and cancel exactly, so they are kept
// out of these sums (dr and dk add them apart), or their rounding would
// swamp a strongly decayed chunk's dlogw (at logw = -8 a float32
// emulation with them misses float64 by far more than 1e-5). The d
// s_T side is a prefix sum, and its last term is taken against h_{c-1}
// rather than h_c = e^{E_{Q-1}} h_{c-1} + sum_j e^{E_{Q-1}-E_j} k_j v_j^T,
// whose j = Q - 1 term would cancel the same way:
//   dlogw_t = sum_{t' >= t} (r_{t'+1} . dr'_{t'+1} - k_t' . dk'_t')
//             + sum_{j < t} k_j . e^{E_{Q-1}-E_j} (dH_c v_j)
//             + e^{E_{Q-1}} rowsum(dH_c * h_{c-1})
// with dr', dk' the intra-chunk sums without the neighbours and the bonus
// (dr' with its h_{c-1} term). Nothing but dH crosses a chunk.
//
// Every exponent is <= 0, as in the forward: the chunk is cut into four
// sub-blocks of 16 steps (b(I) the first, e(J) the last step), and a pair
// of sub-blocks I > J is rebased at their edges,
//   e^{E_{i-1}-E_j} = e^{E_{i-1}-E_{b(I)-1}} g_IJ e^{E_{e(J)}-E_j},
//   g_IJ = e^{E_{b(I)-1}-E_{e(J)}}   (1 for J = I - 1),
// so that dr's sums are M_IJ (k_J e^{E_e - E_j}) scaled by g_IJ and then
// e^{E_{i-1}-E_{b(I)-1}}, dk's M_IJ^T (r_I e^{E_{i-1}-E_{b(I)-1}}) scaled
// by g_IJ and then e^{E_{e(J)}-E_j}, and A_IJ the forward's. Inside a
// sub-block each thread owns a channel and forms e^{E_{i-1}-E_j} as the
// running product of the w_t between (at most 14 factors, each <= 1), for
// A's diagonal sub-blocks (summed over channels by a scattered warp
// reduction) and the diagonal parts of dr and dk. The cumsums run in
// double; an underflow to 0 stands for a term below 1e-38.
//
// What bounds it. At a rwkv6-3b training batch, (4, 2048, 40, 64) bf16,
// no s0, no d s_T, the function reads r, k, v, dy (bf16) and logw (fp32)
// and writes dr, dk, dv (bf16) and dlogw (fp32): 461,393,920 bytes, 0.138
// ms at 3.35 TB/s. Its least work, the chunked form's products on the
// tensor cores, is twice the forward's, 1.17e10 FLOP at 6 bf16 products
// of split terms a multiply-add of two fp32 factors (0.071 ms). So it is
// bound by bytes (chip_smoke.py's wkv_bwd_cost computes this bound).
//
// What this design moves beyond that. Four kernels a call, all named
// wkv_scan_bwd_*, chunk-parallel: a block of 256 threads per (batch, head,
// chunk), 40 x 32 x 4 = 5120 at batch 4, heads fastest in launch order.
//  1. wkv_scan_bwd_state: the cumsums, the chunk's decay e^{E_{Q-1}} and
//     ds_c (hd x hd, K = Q steps) into the scratch, and the r side: M
//     (its lower 16 x 16 tiles), dr, r . dr' (into dlogw, which kernel 3
//     finishes) and du's partial of the chunk. Two blocks an SM (112,384
//     bytes of shared memory in bf16; ptxas: 128 registers, 20 bytes of
//     spills), so the thread's steps are loaded again for its last phase.
//  2. wkv_scan_bwd_pass, per (batch, head), 4 elements of hd x hd a
//     thread: dH_c from d s_T (or zeros) down the chunks, overwriting each
//     ds_c; the next 8 chunks' loads in flight while 8 are applied; ds0.
//  3. wkv_scan_bwd_chunk: the k and v sides and dlogw: A (off-diagonal
//     sub-blocks on the tensor cores, diagonal ones per channel), M again,
//     dk, dv, and the suffix and prefix sums of dlogw. A block an SM
//     (175,616 bytes in bf16; ptxas: 243 registers, no spills), so that
//     each thread keeps its steps in registers to the end and every
//     operand is split into bf16 term tiles once and read with ldmatrix.
//  4. wkv_scan_bwd_du: du as the sum of the (batch, chunk) partials in a
//     fixed order.
// Its own traffic: kernels 1 and 3 each read r, k, v, dy, logw and h_{c-1}
// (84 MB of fp32 chunk states), the scratch ds_c / dH_c (84 MB) is
// written by 1, read and written by 2 and read by 3, and r . dr' (84 MB)
// is written by 1 and read by 3: about 0.9 GB beyond the function's
// bytes, a floor near 0.41 ms at 3.35 TB/s. dr, dk and dv are written
// once each in their dtype (no fp32 atomics, no cast pass), and every sum
// runs in a fixed order, so all six gradients are bitwise the same from
// run to run. The kernels are bound by issue and latency rather than by
// those bytes (chip_smoke.py prints each one's time); the forward's L2
// prefetch a wave ahead made both chunk kernels slower here, and is left
// out.
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). dy and v are
// exact bf16 operands (fp32 ones split into 3 bf16 terms); every fp32
// factor (M, A, the rebased r and k, h_{c-1}, dH_c) is split into 3 bf16
// terms, and the products of terms i, j with i + j <= 2 are kept (6 for
// two fp32 factors, 3 against bf16), each k step's into a zeroed
// accumulator that is then added to the fp32 total (common.cuh).
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace wkv;   // NT, QM, HM, SB, NSB and the scans' helpers

constexpr int FLD = 72;   // fp32 rows read as float2 fragment pairs
constexpr int HLD = 68;   // fp32 rows read a column at a time
constexpr int NTILE = NSB * (NSB + 1) / 2;   // lower 16 x 16 tiles of Q x Q

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
  void* dv;
  float* dlogw;          // r . dr' after kernel 1, dlogw after kernel 3
  float* du;
  float* ds0;            // nullptr: not wanted
  float* dstate;         // (B, nh, nc, hd, hd): ds_c, then dH_c
  float* decay;          // (B, nh, nc, hd): e^{E_{Q-1}}
  float* dupart;         // (B, nc, nh, hd)
  int B, S, nh, hd, Q, nc;
};

// Packed lower tiles of a Q x Q matrix: tile (I, J), J <= I, is 16 rows of
// LD floats at (I (I + 1) / 2 + J) 16 LD.
template <int LD>
__device__ __forceinline__ float* tile_at(float* m, int I, int J) {
  return m + (I * (I + 1) / 2 + J) * SB * LD;
}
template <int LD>
__device__ __forceinline__ float at(const float* m, int i, int j) {
  return m[((i / SB) * (i / SB + 1) / 2 + j / SB) * SB * LD
           + (i % SB) * LD + j % SB];
}

// g_IJ = e^{E_{b(I)-1} - E_{e(J)}} for I - J >= 2: (2, 0), (3, 1), (3, 0)
// are rows 0, 1, 2 of G.
__device__ __forceinline__ int g_row(int I, int J) {
  return I - J == 3 ? 2 : J;
}

// The 16 x 16 tile (I, J) of M = DY V^T (rows 16 I.., columns 16 J..), K
// = hd: both operands from their staged bf16 terms (ldmatrix), the
// products of terms i + j <= 2; c[n] holds columns 16 J + 8 n...
template <int K>
__device__ __forceinline__ void m_tile(const __nv_bfloat16* DYs,
                                       const __nv_bfloat16* Vs, int I, int J,
                                       int hd, float (&c)[2][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < HM / 16; ++ks) {
    if (ks * 16 >= hd) break;
    float st[2][4] = {};
    uint32_t a[K][4], bt[K][4];
#pragma unroll
    for (int e = 0; e < K; ++e) {
      ldsm_x4(a[e], smem_u32(DYs + e * QM * TILE_LD
                             + a_lane(16 * I, 16 * ks, lane)));
      ldsm_x4(bt[e], smem_u32(Vs + e * QM * TILE_LD
                              + bt_lane(16 * J, 16 * ks, lane)));
    }
#pragma unroll
    for (int jt = K - 1; jt >= 0; --jt)
#pragma unroll
      for (int it = (2 - jt < K - 1 ? 2 - jt : K - 1); it >= 0; --it)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_bf16(st[n], a[it], bt[jt][2 * n], bt[jt][2 * n + 1]);
    add_to(c, st);
  }
}

// Stores a 16 x 16 accumulator pair (columns 8 n..) at m, an fp32 array
// with row stride LD.
template <int LD>
__device__ __forceinline__ void store_tile(float* m, const float (&c)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(m + (g + (e >> 1) * 8) * LD + n * 8 + 2 * t)
          = make_float2(c[n][e], c[n][e + 1]);
}

// Four floats split into 3 bf16 terms each, stored at element `off` of
// the term tiles dst[t] (QM x TILE_LD each; off a multiple of 4).
__device__ __forceinline__ void put_terms(__nv_bfloat16* dst, int off,
                                          float4 x) {
  uint32_t lo[3], hi[3];
  split_pack<3>(x.x, x.y, lo);
  split_pack<3>(x.z, x.w, hi);
#pragma unroll
  for (int e = 0; e < 3; ++e)
    *reinterpret_cast<uint2*>(dst + e * QM * TILE_LD + off) =
        make_uint2(lo[e], hi[e]);
}

// The lower 16 x 16 tiles (I, J) with J >= j0 of a packed matrix (row
// stride MT) as 3-term tiles at rows 16 I, columns 16 J of dst, by the
// whole block; with `nb`, tile (I, I - 1)'s entry (0, 15), the
// neighbours' M, is 0.
template <int MT>
__device__ __forceinline__ void put_tiles(__nv_bfloat16* dst, const float* m,
                                          bool nb) {
  for (int e = threadIdx.x; e < NTILE * 64; e += NT) {
    const int q = e / 64, il = e % 64 / 4, jl = e % 4 * 4;
    const int I = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3, J = q - I * (I + 1) / 2;
    float4 x = *reinterpret_cast<const float4*>(m + q * SB * MT + il * MT + jl);
    if (nb && J == I - 1 && il == 0 && jl == 12) x.w = 0.0f;
    put_terms(dst, (16 * I + il) * TILE_LD + 16 * J + jl, x);
  }
}

// st (16 x 32) += the products of terms i + j <= 2 of A (KA terms, x4
// fragments a[i]) and B (KB terms, two x4 fragments each, columns 16 n2..),
// smallest first.
template <int KA, int KB>
__device__ __forceinline__ void mma_tt(float (&st)[4][4],
                                       const uint32_t (&a)[KA][4],
                                       const uint32_t (&bb)[KB][2][4]) {
#pragma unroll
  for (int jt = KB - 1; jt >= 0; --jt)
#pragma unroll
    for (int it = (2 - jt < KA - 1 ? 2 - jt : KA - 1); it >= 0; --it)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma_bf16(st[n], a[it], bb[jt][n / 2][(n % 2) * 2],
                 bb[jt][n / 2][(n % 2) * 2 + 1]);
}

// Column `col` of accumulator element (n, e) of a 16 x 32 tile at column
// n0, and its row (0..15).
__device__ __forceinline__ int acc_col(int n0, int n, int e) {
  return n0 + 8 * n + 2 * (threadIdx.x % 4) + (e & 1);
}
__device__ __forceinline__ int acc_row(int e) {
  return (threadIdx.x % 32) / 4 + (e >> 1) * 8;
}

// Stores a 16 x 32 accumulator at rows r0, columns n0 of an fp32 array
// with row stride FLD.
__device__ __forceinline__ void store_acc(float* m, int r0, int n0,
                                          const float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(m + (r0 + acc_row(e)) * FLD
                                 + acc_col(n0, n, e))
          = make_float2(acc[n][e], acc[n][e + 1]);
}

// Thread (c, I)'s steps again, for kernel 1's last phase: r, k and
// e^{logw} of its 16 steps, and e^{E_{i-1} - E_{b(I)-1}} of each, from
// the sub-block cumsums in double.
template <typename T>
__device__ __forceinline__ void reload(const Params& p, size_t base,
                                       float (&rk)[2][SB], float (&w)[SB],
                                       float (&fr)[SB]) {
  const T* const src[2] = {static_cast<const T*>(p.r),
                           static_cast<const T*>(p.k)};
  own_steps<T, 2>(p, base, src, w, rk);
  double L[SB];
  local_cumsum(w, L);
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    fr[s] = s ? expf((float)L[s - 1]) : 1.0f;
    w[s] = expf(w[s]);
  }
}

// Group J of A's diagonal sub-block over the warp's 32 channels, from
// each lane's r, k and w = e^{logw} of its channel's 16 steps: column J of
// the pairs (i > J, 15 - J sums) and column 14 - J (J + 1 sums; none for
// J = 7), r_i k_j times the running product of the w between, summed over
// the warp by a scattered reduction; the even lanes store the sums at
// pair (i, j)'s slot i (i - 1) / 2 + j of `ad`.
template <int J>
__device__ __forceinline__ void a_diag_group(const float (&r)[SB],
                                             const float (&k)[SB],
                                             const float (&w)[SB],
                                             float* ad) {
  constexpr int J2 = 14 - J, N1 = 15 - J;
  float v[16];
  float d = 1.0f;
#pragma unroll
  for (int q = 0; q < N1; ++q) {
    if (q) d *= w[J + q];
    v[q] = r[J + 1 + q] * (k[J] * d);
  }
  d = 1.0f;
#pragma unroll
  for (int q = 0; q < 16 - N1; ++q) {
    if constexpr (J == 7) {
      v[N1 + q] = 0.0f;
    } else {
      if (q) d *= w[J2 + q];
      v[N1 + q] = r[J2 + 1 + q] * (k[J2] * d);
    }
  }
  const float sum = warp_reduce_scatter(v);
  const int lane = threadIdx.x % 32, slot = (lane >> 1) & 15;
  if ((lane & 1) || (J == 7 && slot >= N1)) return;
  const int i = slot < N1 ? J + 1 + slot : J2 + 1 + slot - N1;
  ad[i * (i - 1) / 2 + (slot < N1 ? J : J2)] = sum;
}

// 1. The r side of one (batch, head, chunk): e^{E_{Q-1}}, ds_c, dr, r .
// dr' and du's partial.
template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv_scan_bwd_state(Params p) {
  constexpr int K = terms<T>(), MT = 24;
  extern __shared__ __align__(16) unsigned char smem[];
  double* tot = reinterpret_cast<double*>(smem);           // NSB x HM
  float* Eb = reinterpret_cast<float*>(tot + NSB * HM);    // NSB x HM
  float* G = Eb + NSB * HM;          // 3 x HM: g_20, g_31, g_30
  float* KL = G + 3 * HM;            // NSB x HM: k at each sub-block's end
  float* DU = KL + NSB * HM;         // NSB x HM: du partials
  float* RE = DU + NSB * HM;         // QM x HLD: r e^{E_{i-1}}
  float* Ms = RE + QM * HLD;         // NTILE x 16 x MT: M's lower tiles
  // 3 terms each: k e^{E_{e(J)} - E_j}; h_{c-1}, then dr's sums (fp32)
  __nv_bfloat16* KKt = reinterpret_cast<__nv_bfloat16*>(Ms + NTILE * SB * MT);
  __nv_bfloat16* Ht = KKt + 3 * QM * TILE_LD;
  __nv_bfloat16* DYs = Ht + 3 * QM * TILE_LD;   // K terms each: dy, v
  __nv_bfloat16* Vs = DYs + K * QM * TILE_LD;
  const int h = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % HM, I = tid / HM;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)p.nh * p.hd;
  const size_t base = ((size_t)b * p.S + (size_t)ch * p.Q) * row
      + (size_t)h * p.hd;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + ch;
  {   // every load of the block in flight before any is used
    Tile<QM, T> dyt(static_cast<const T*>(p.dy) + base, row, p.Q, p.hd);
    Tile<QM, T> vt(static_cast<const T*>(p.v) + base, row, p.Q, p.hd);
    Tile<HM, float> ht(p.states + bhc * p.hd * p.hd, p.hd, p.hd, p.hd);
    const T* const src[2] = {static_cast<const T*>(p.r),
                             static_cast<const T*>(p.k)};
    float w[SB], rk[2][SB];
    own_steps<T, 2>(p, base, src, w, rk);
    dyt.template store_terms<K>(DYs);
    vt.template store_terms<K>(Vs);
    ht.template store_terms<3>(Ht);
    double L[SB];
    local_cumsum(w, L);
    tot[I * HM + c] = L[SB - 1];
    KL[I * HM + c] = rk[1][SB - 1];
    __syncthreads();
    double before = 0.0, all = 0.0;
#pragma unroll
    for (int e = 0; e < NSB; ++e) {
      const double x = tot[e * HM + c];
      if (e < I) before += x;
      all += x;
    }
    Eb[I * HM + c] = expf((float)before);
    if (I == 0) {
      const double t1 = tot[HM + c], t2 = tot[2 * HM + c];
      G[c] = expf((float)t1);
      G[HM + c] = expf((float)t2);
      G[2 * HM + c] = expf((float)(t1 + t2));
      if (c < p.hd) p.decay[bhc * p.hd + c] = expf((float)all);
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int i = I * SB + s;
      RE[i * HLD + c] = rk[0][s] * expf((float)(before + (s ? L[s - 1] : 0.0)));
      float x = rk[1][s] * expf((float)(L[SB - 1] - L[s]));
#pragma unroll
      for (int e = 0; e < 3; ++e) {   // k e^{E_e - E_j} as 3 bf16 terms
        const __nv_bfloat16 y = __float2bfloat16_rn(x);
        KKt[e * QM * TILE_LD + i * TILE_LD + c] = y;
        x -= __bfloat162float(y);
      }
    }
  }
  __syncthreads();
  // M's 10 lower tiles: warp w takes tiles w and w + 8
  for (int q = warp; q < NTILE; q += 8) {
    const int I2 = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
    const int J2 = q - I2 * (I2 + 1) / 2;
    float c2[2][4] = {};
    if (16 * J2 < p.Q) m_tile<K>(DYs, Vs, I2, J2, p.hd, c2);
    store_tile<MT>(tile_at<MT>(Ms, I2, J2), c2);
  }
  __syncthreads();

  // dr's sums: warp w owns rows 16 (w % 4).. (sub-block rb) and channels
  // 32 (w / 4)..; e^{E_{b-1}} (h_{c-1} dy_i) and g_IJ (M_IJ KK_J), J < rb,
  // without the neighbour M_{16 rb, 16 rb - 1}
  const int rb = warp % 4, n0 = (warp / 4) * 32;
  const bool live = n0 < p.hd && rb * 16 < p.Q;
  float X[4][4] = {};
  if (live) {
#pragma unroll
    for (int ks = 0; ks < HM / 16; ++ks) {   // dy_i h_{c-1}^T, K = hd
      if (ks * 16 >= p.hd) break;
      float st[4][4] = {};
      uint32_t a[K][4], bb[3][2][4];
#pragma unroll
      for (int e = 0; e < K; ++e)
        ldsm_x4(a[e], smem_u32(DYs + e * QM * TILE_LD
                               + a_lane(16 * rb, 16 * ks, lane)));
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4(bb[e][n2], smem_u32(Ht + e * QM * TILE_LD
                                      + bt_lane(n0 + 16 * n2, 16 * ks,
                                                lane)));
      mma_tt<K, 3>(st, a, bb);
      add_to(X, st);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) X[n][e] *= Eb[rb * HM + acc_col(n0, n, e)];
    for (int J = 0; J < rb; ++J) {
      const float* Mt = tile_at<MT>(Ms, rb, J);
      uint32_t a[3][4], bb[3][2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 x = *reinterpret_cast<const float2*>(
            Mt + (g + (q & 1) * 8) * MT + 2 * t + (q >> 1) * 8);
        if (J == rb - 1 && q == 2 && g == 0 && t == 3) x.y = 0.0f;
        uint32_t tq[3];
        split_pack<3>(x.x, x.y, tq);
#pragma unroll
        for (int e = 0; e < 3; ++e) a[e][q] = tq[e];
      }
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[e][n2], smem_u32(KKt + e * QM * TILE_LD
                                            + b_lane(16 * J, n0 + 16 * n2,
                                                     lane)));
      float st[4][4] = {};
      mma_tt<3, 3>(st, a, bb);
      const float* gr = J == rb - 1 ? nullptr : G + g_row(rb, J) * HM;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          X[n][e] += gr ? gr[acc_col(n0, n, e)] * st[n][e] : st[n][e];
    }
  }
  // ds_c = (r e^{E_{i-1}})^T dy: warp w owns rows (channels) 16 (w % 4)..
  // and columns 32 (w / 4)..; RE read a column at a time
  if (rb * 16 < p.hd && n0 < p.hd) {
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < QM / 16; ++ks) {
      if (ks * 16 >= p.Q) break;
      float st[4][4] = {};
      uint32_t a[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cc = rb * 16 + g + (q & 1) * 8;
        const int i = ks * 16 + 2 * t + (q >> 1) * 8;
        split_pack<3>(RE[i * HLD + cc], RE[(i + 1) * HLD + cc], a[q]);
      }
#pragma unroll
      for (int jt = K - 1; jt >= 0; --jt) {
        uint32_t bb[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[n2], smem_u32(DYs + jt * QM * TILE_LD
                                         + b_lane(ks * 16, n0 + 16 * n2,
                                                  lane)));
        mma_terms(st, a, bb, 2 - jt);
      }
      add_to(acc, st);
    }
    float* out = p.dstate + bhc * p.hd * p.hd;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = rb * 16 + acc_row(e), d = acc_col(n0, n, e);
        if (cc < p.hd && d < p.hd) out[cc * p.hd + d] = acc[n][e];
      }
  }
  __syncthreads();   // h_{c-1} is read out: its terms take dr's sums
  float* Out = reinterpret_cast<float*>(Ht);
  store_acc(Out, 16 * rb, n0, X);
  __syncthreads();

  // thread (c, I): the diagonal sub-block's pairs j < i - 1, the
  // neighbour and the bonus; dr, r . dr' and du's partial
  float rk[2][SB], w[SB], fr[SB];
  reload<T>(p, base, rk, w, fr);
  float drd[SB] = {};
  const float* Md = tile_at<MT>(Ms, I, I);
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    float d = 1.0f;
#pragma unroll
    for (int i = j + 2; i < SB; ++i) {
      d *= w[i - 1];
      drd[i] = fmaf(Md[i * MT + j], rk[1][j] * d, drd[i]);
    }
  }
  const float u = c < p.hd ? p.u[(size_t)h * p.hd + c] : 0.0f;
  T* dR = static_cast<T*>(p.dr);
  float du = 0.0f;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int i = I * SB + s;
    const float mii = Md[s * MT + s];
    const float kprev = s ? rk[1][s - 1] : I ? KL[(I - 1) * HM + c] : 0.0f;
    const float nb = i ? at<MT>(Ms, i, i - 1) * kprev : 0.0f;
    const float dro = fr[s] * Out[i * FLD + c] + drd[s];
    du += rk[0][s] * rk[1][s] * mii;
    if (i < p.Q && c < p.hd) {
      const size_t off = base + (size_t)i * row + c;
      store(dR, off, dro + nb + u * rk[1][s] * mii);
      p.dlogw[off] = rk[0][s] * dro;
    }
  }
  DU[I * HM + c] = du;
  __syncthreads();
  if (I == 0 && c < p.hd)
    p.dupart[(((size_t)b * p.nc + ch) * p.nh + h) * p.hd + c] =
        ((DU[c] + DU[HM + c]) + DU[2 * HM + c]) + DU[3 * HM + c];
}

// 2. dH_c = e^{E_{Q-1},c+1} dH_{c+1} + ds_{c+1} down the chunks of one
// (batch, head) from d s_T (or zeros), 4 elements of hd x hd a thread; the
// next 8 chunks' loads are in flight while 8 are applied. ds_c is
// overwritten by dH_c, and ds0 written when wanted.
__global__ void __launch_bounds__(NT) wkv_scan_bwd_pass(Params p) {
  const int n = p.hd * p.hd, e0 = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e0 >= n) return;
  const int m = min(4, n - e0);
  // hd % 4 == 0: every run of 4 is 16-byte aligned and in one row
  const bool vec = p.hd % 4 == 0;
  const size_t bh = blockIdx.y;
  float* __restrict__ st = p.dstate + bh * p.nc * n + e0;
  const float* __restrict__ dec = p.decay + bh * p.nc * p.hd;
  int cr[4];                         // the channel (row) of each element
  float dh[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cr[e] = min(e0 + e, n - 1) / p.hd;
    dh[e] = p.dsT && e < m ? p.dsT[bh * n + e0 + e] : 0.0f;
  }
  // chunks c0, c0 - 1, .., c0 - 7
  auto fetch = [&](int c0, float (&s)[8][4], float (&a)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in = c0 - k >= 0;
      const float* src = st + (size_t)(in ? c0 - k : 0) * n;
      if (in && vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[k][0] = v.x, s[k][1] = v.y, s[k][2] = v.z, s[k][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[k][e] = in && e < m ? src[e] : 0.0f;
      }
      a[k] = in ? __ldg(dec + (size_t)(c0 - k) * p.hd + cr[0]) : 0.0f;
    }
  };
  float s[8][4], a[8], ns[8][4], na[8];
  fetch(p.nc - 1, s, a);
  for (int c0 = p.nc - 1; c0 >= 0; c0 -= 8) {
    fetch(c0 - 8, ns, na);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int cc = c0 - k;
      if (cc < 0) break;
      float* dst = st + (size_t)cc * n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(dh[0], dh[1], dh[2], dh[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) dh[e] = a[k] * dh[e] + s[k][e];
      } else {
        const float* dk = dec + (size_t)cc * p.hd;
        for (int e = 0; e < m; ++e) {
          dst[e] = dh[e];
          dh[e] = __ldg(dk + cr[e]) * dh[e] + s[k][e];
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
  if (p.ds0)
    for (int e = 0; e < m; ++e) p.ds0[bh * n + e0 + e] = dh[e];
}

// 3. The k and v sides of one (batch, head, chunk) and its dlogw. Every
// operand of a product is split into bf16 term tiles once and read with
// ldmatrix: dH_c when it is staged; A, then M, and k e^{E_{Q-1}-E_j},
// then r e^{E_{i-1}-E_{b-1}}, into one pair of regions in turn. A block an
// SM, with the shared memory that takes.
template <typename T>
__global__ void __launch_bounds__(NT, 1) wkv_scan_bwd_chunk(Params p) {
  constexpr int K = terms<T>(), MT = 20, TT = 3 * QM * TILE_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  double* tot = reinterpret_cast<double*>(smem);           // NSB x HM
  float* Ea = reinterpret_cast<float*>(tot + NSB * HM);    // NSB x HM
  float* G = Ea + NSB * HM;          // 3 x HM: g_20, g_31, g_30
  float* RF = G + 3 * HM;            // NSB x HM: r at each sub-block's start
  float* SUM = RF + NSB * HM;        // 2 x NSB x HM: per sub-block sums
  float* HR = SUM + 2 * NSB * HM;    // HM: rowsum(dH_c * h_{c-1})
  float* bonus = HR + HM;            // 2 x QM: r.(u k), a half of hd each
  float* AD = bonus + 2 * QM;        // 2 x NSB x 128: A's diagonal tiles,
                                     // a half of the channels each
  float* RR = AD + 2 * NSB * 128;    // QM x FLD: r e^{E_{i-1} - E_{b-1}}
  float* KK = RR + QM * FLD;         // QM x FLD: k e^{E_{e(J)} - E_j}
  float* Ms = KK + QM * FLD;         // NTILE x 16 x MT: M's lower tiles
  float* As = Ms + NTILE * SB * MT;  // NTILE x 16 x MT: A's lower tiles
  __nv_bfloat16* Ht = reinterpret_cast<__nv_bfloat16*>(As + NTILE * SB * MT);
  __nv_bfloat16* X = Ht + TT;        // 3 terms: k e^{E_{Q-1}-E_j}, then M
  __nv_bfloat16* Y = X + TT;         // 3 terms: A, then r e^{E_{i-1}-E_b}
  __nv_bfloat16* DYs = Y + TT;       // K terms each: dy, v
  __nv_bfloat16* Vs = DYs + K * QM * TILE_LD;
  const int h = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c = tid % HM, I = tid / HM;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)p.nh * p.hd;
  const size_t base = ((size_t)b * p.S + (size_t)ch * p.Q) * row
      + (size_t)h * p.hd;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + ch;
  // thread (c, I)'s r, k, e^{logw}, e^{E_{e(I)} - E_i} and r . dr' of the
  // next step (kernel 1's), kept to the end
  float rk[2][SB], w[SB], fk[SB], pn[SB];
  {   // every load of the block in flight before any is used
    Tile<QM, T> dyt(static_cast<const T*>(p.dy) + base, row, p.Q, p.hd);
    Tile<QM, T> vt(static_cast<const T*>(p.v) + base, row, p.Q, p.hd);
    Tile<HM, float> ht(p.dstate + bhc * p.hd * p.hd, p.hd, p.hd, p.hd);
    Tile<HM, float> hp(p.states + bhc * p.hd * p.hd, p.hd, p.hd, p.hd);
    const T* const src[2] = {static_cast<const T*>(p.r),
                             static_cast<const T*>(p.k)};
    own_steps<T, 2>(p, base, src, w, rk);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int i = I * SB + s;
      pn[s] = i + 1 < p.Q && c < p.hd
          ? p.dlogw[base + (size_t)(i + 1) * row + c] : 0.0f;
    }
    const float u = c < p.hd ? p.u[(size_t)h * p.hd + c] : 0.0f;
    // rowsum(dH_c * h_{c-1}): the 16 threads of a tile row, then a
    // shuffle sum (both tiles map elements to threads alike)
#pragma unroll
    for (int k = 0; k < Tile<HM, float>::PER; ++k) {
      float x = ((ht.v[k][0] * hp.v[k][0] + ht.v[k][1] * hp.v[k][1])
                 + ht.v[k][2] * hp.v[k][2]) + ht.v[k][3] * hp.v[k][3];
#pragma unroll
      for (int l = 1; l < 5; ++l) x += __shfl_xor_sync(0xffffffffu, x, 16 >> l);
      if (tid % 16 == 0) HR[ht.row(k)] = x;
    }
    dyt.template store_terms<K>(DYs);
    vt.template store_terms<K>(Vs);
    ht.template store_terms<3>(Ht);
    double L[SB];
    local_cumsum(w, L);
    tot[I * HM + c] = L[SB - 1];
    RF[I * HM + c] = rk[0][0];
    float bo[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int i = I * SB + s;
      RR[i * FLD + c] = rk[0][s] * (s ? expf((float)L[s - 1]) : 1.0f);
      fk[s] = expf((float)(L[SB - 1] - L[s]));
      KK[i * FLD + c] = rk[1][s] * fk[s];
      bo[s] = rk[0][s] * (u * rk[1][s]);
      w[s] = expf(w[s]);
    }
    // r.(u k) over this warp's 32 channels; lane 2 s holds step s's
    const float part = warp_reduce_scatter(bo);
    if (!(lane & 1)) bonus[(warp & 1) * QM + I * SB + lane / 2] = part;
    // A's diagonal sub-block over this warp's channels
    float* ad = AD + ((warp & 1) * NSB + I) * 128;
    a_diag_group<0>(rk[0], rk[1], w, ad);
    a_diag_group<1>(rk[0], rk[1], w, ad);
    a_diag_group<2>(rk[0], rk[1], w, ad);
    a_diag_group<3>(rk[0], rk[1], w, ad);
    a_diag_group<4>(rk[0], rk[1], w, ad);
    a_diag_group<5>(rk[0], rk[1], w, ad);
    a_diag_group<6>(rk[0], rk[1], w, ad);
    a_diag_group<7>(rk[0], rk[1], w, ad);
  }
  __syncthreads();
  {
    double after = 0.0;
#pragma unroll
    for (int e = 0; e < NSB; ++e)
      if (e > I) after += tot[e * HM + c];
    Ea[I * HM + c] = expf((float)after);
    if (I == 0) {
      const double t1 = tot[HM + c], t2 = tot[2 * HM + c];
      G[c] = expf((float)t1);
      G[HM + c] = expf((float)t2);
      G[2 * HM + c] = expf((float)(t1 + t2));
    }
  }
  // A's diagonal tiles: the two halves of the channels, zeros on and above
  // the diagonal
  {
    const int il = tid / SB, jl = tid % SB;
#pragma unroll
    for (int blk = 0; blk < NSB; ++blk) {
      const int s = il * (il - 1) / 2 + jl;
      tile_at<MT>(As, blk, blk)[il * MT + jl] = jl < il
          ? AD[blk * 128 + s] + AD[(NSB + blk) * 128 + s] : 0.0f;
    }
  }
  __syncthreads();
  if (warp < 6) {
    // A off the diagonal: warp w < 6 computes the 16 x 16 tile of
    // sub-block pair (I, J) = (1, 0), (2, 1), (3, 2), (2, 0), (3, 0),
    // (3, 1), K = hd, as the forward does
    const int tI = warp < 3 ? warp + 1 : warp == 3 ? 2 : 3;
    const int tJ = warp < 3 ? warp : warp == 5 ? 1 : 0;
    float at2[2][4] = {};
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
          const float2 gg = *reinterpret_cast<const float2*>(
              G + g_row(tI, tJ) * HM + cc);
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
      add_to(at2, st);
    }
    store_tile<MT>(tile_at<MT>(As, tI, tJ), at2);
  } else {
    // M's 10 lower tiles: warp 6 + e takes tiles e, e + 2, ..
    for (int q = warp - 6; q < NTILE; q += 2) {
      const int I2 = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
      const int J2 = q - I2 * (I2 + 1) / 2;
      float c2[2][4] = {};
      if (16 * J2 < p.Q) m_tile<K>(DYs, Vs, I2, J2, p.hd, c2);
      store_tile<MT>(tile_at<MT>(Ms, I2, J2), c2);
    }
  }
  __syncthreads();
  // k e^{E_{Q-1}-E_j} = KK e^{E_{Q-1}-E_{e(J)}} and A as 3-term tiles
  for (int e = tid; e < QM * HM / 4; e += NT) {
    const int i = e / 16, j = e % 16 * 4;
    const float4 x = *reinterpret_cast<const float4*>(KK + i * FLD + j);
    const float4 a = *reinterpret_cast<const float4*>(Ea + i / SB * HM + j);
    put_terms(X, i * TILE_LD + j,
              make_float4(x.x * a.x, x.y * a.y, x.z * a.z, x.w * a.w));
  }
  put_tiles<MT>(Y, As, false);
  __syncthreads();

  // warp w owns rows 16 (w % 4).. (sub-block rb) and columns 32 (w / 4)..
  // of dv, then of dk
  const int rb = warp % 4, n0 = (warp / 4) * 32;
  const bool live = n0 < p.hd && rb * 16 < p.Q;
  if (live) {
    // dv = (k e^{E_{Q-1}-E_j}) dH_c + A^T dy + r.(u k) dy
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < HM / 16; ++ks) {
      if (ks * 16 >= p.hd) break;
      float st[4][4] = {};
      uint32_t a[3][4], bb[3][2][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        ldsm_x4(a[e], smem_u32(X + e * QM * TILE_LD
                               + a_lane(16 * rb, 16 * ks, lane)));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[e][n2], smem_u32(Ht + e * QM * TILE_LD
                                            + b_lane(16 * ks, n0 + 16 * n2,
                                                     lane)));
      }
      mma_tt<3, 3>(st, a, bb);
      add_to(acc, st);
    }
    for (int I2 = rb; I2 < NSB; ++I2) {   // A^T: ldmatrix.trans of A
      if (I2 * 16 >= p.Q) break;
      float st[4][4] = {};
      uint32_t a[3][4], bb[K][2][4];
#pragma unroll
      for (int e = 0; e < 3; ++e)
        ldsm_x4_trans(a[e], smem_u32(Y + e * QM * TILE_LD
                                     + bt_lane(16 * I2, 16 * rb, lane)));
#pragma unroll
      for (int e = 0; e < K; ++e)
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[e][n2], smem_u32(DYs + e * QM * TILE_LD
                                            + b_lane(16 * I2, n0 + 16 * n2,
                                                     lane)));
      mma_tt<3, K>(st, a, bb);
      add_to(acc, st);
    }
    T* dV = static_cast<T*>(p.dv);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = rb * 16 + acc_row(e), d = acc_col(n0, n, e);
        if (j >= p.Q || d >= p.hd) continue;
        float y = 0.0f;     // dy from its staged terms (dy itself when bf16)
#pragma unroll
        for (int k = K - 1; k >= 0; --k)
          y += __bfloat162float(DYs[k * QM * TILE_LD + j * TILE_LD + d]);
        store(dV, base + (size_t)j * row + d,
              acc[n][e] + (bonus[j] + bonus[QM + j]) * y);
      }
  }
  __syncthreads();   // X and Y are read out: M and RR take them
  put_tiles<MT>(X, Ms, true);
  for (int e = tid; e < QM * HM / 4; e += NT) {
    const int i = e / 16, j = e % 16 * 4;
    put_terms(Y, i * TILE_LD + j,
              *reinterpret_cast<const float4*>(RR + i * FLD + j));
  }
  __syncthreads();
  float YH[4][4] = {}, Yi[4][4] = {};
  if (live) {
    // dk's sums: e^{E_{Q-1}-E_{e(J)}} (dH_c v_j) and g_IJ (M_IJ^T RR_I),
    // I > rb, without the neighbour M_{16 rb + 16, 16 rb + 15}
#pragma unroll
    for (int ks = 0; ks < HM / 16; ++ks) {
      if (ks * 16 >= p.hd) break;
      float st[4][4] = {};
      uint32_t a[K][4], bb[3][2][4];
#pragma unroll
      for (int e = 0; e < K; ++e)
        ldsm_x4(a[e], smem_u32(Vs + e * QM * TILE_LD
                               + a_lane(16 * rb, 16 * ks, lane)));
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4(bb[e][n2], smem_u32(Ht + e * QM * TILE_LD
                                      + bt_lane(n0 + 16 * n2, 16 * ks,
                                                lane)));
      mma_tt<K, 3>(st, a, bb);
      add_to(YH, st);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) YH[n][e] *= Ea[rb * HM + acc_col(n0, n, e)];
    for (int I2 = rb + 1; I2 < NSB; ++I2) {   // M^T: ldmatrix.trans of M
      if (I2 * 16 >= p.Q) break;
      float st[4][4] = {};
      uint32_t a[3][4], bb[3][2][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        ldsm_x4_trans(a[e], smem_u32(X + e * QM * TILE_LD
                                     + bt_lane(16 * I2, 16 * rb, lane)));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[e][n2], smem_u32(Y + e * QM * TILE_LD
                                            + b_lane(16 * I2, n0 + 16 * n2,
                                                     lane)));
      }
      mma_tt<3, 3>(st, a, bb);
      const float* gr = I2 == rb + 1 ? nullptr : G + g_row(I2, rb) * HM;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Yi[n][e] += gr ? gr[acc_col(n0, n, e)] * st[n][e] : st[n][e];
    }
  }
  // RR and KK are read out (into Y and X): their rows take dk's sums
  float* OutH = RR;
  float* OutY = KK;
  store_acc(OutH, 16 * rb, n0, YH);
  store_acc(OutY, 16 * rb, n0, Yi);

  // thread (c, I): the diagonal sub-block's pairs i > j + 1, the
  // neighbour and the bonus; dk, and dlogw's three sums
  float dkd[SB] = {};
  const float* Md = tile_at<MT>(Ms, I, I);
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    float d = 1.0f;
#pragma unroll
    for (int i = j + 2; i < SB; ++i) {
      d *= w[i - 1];
      dkd[j] = fmaf(Md[i * MT + j], rk[0][i] * d, dkd[j]);
    }
  }
  __syncthreads();
  const float u = c < p.hd ? p.u[(size_t)h * p.hd + c] : 0.0f;
  T* dK = static_cast<T*>(p.dk);
  float asum = 0.0f, bsum = 0.0f;   // pn becomes a, dkd b, in place
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const int i = I * SB + s;
    const float dkh = fk[s] * OutH[i * FLD + c];
    const float dko = fk[s] * OutY[i * FLD + c] + dkd[s];
    const float rnext = s < SB - 1 ? rk[0][s + 1]
        : I < NSB - 1 ? RF[(I + 1) * HM + c] : 0.0f;
    const float nb = i + 1 < QM ? at<MT>(Ms, i + 1, i) * rnext : 0.0f;
    if (i < p.Q && c < p.hd)
      store(dK, base + (size_t)i * row + c,
            ((dkh + dko) + nb) + u * rk[0][s] * Md[s * MT + s]);
    pn[s] -= rk[1][s] * dko;
    dkd[s] = rk[1][s] * dkh;
    asum += pn[s];
    bsum += dkd[s];
  }
  SUM[I * HM + c] = asum;
  SUM[(NSB + I) * HM + c] = bsum;
  __syncthreads();
  float suf = 0.0f, pre = 0.0f, whole = HR[c], all = 0.0f;
#pragma unroll
  for (int e = 0; e < NSB; ++e) {
    if (e > I) suf += SUM[e * HM + c];
    if (e < I) pre += SUM[(NSB + e) * HM + c];
  }
  {
    double tall = 0.0;
#pragma unroll
    for (int e = 0; e < NSB; ++e) tall += tot[e * HM + c];
    all = expf((float)tall);
  }
  whole *= all;
#pragma unroll
  for (int s = 0; s < SB; ++s) {   // b summed over the earlier steps
    const float x = dkd[s];
    dkd[s] = pre;
    pre += x;
  }
#pragma unroll
  for (int s = SB - 1; s >= 0; --s) {   // a summed over the later ones
    suf += pn[s];
    const int i = I * SB + s;
    if (i < p.Q && c < p.hd)
      p.dlogw[base + (size_t)i * row + c] = (suf + dkd[s]) + whole;
  }
}

// 4. du = the (batch, chunk) partials summed in a fixed order, a thread an
// entry of (nh, hd).
__global__ void __launch_bounds__(NT) wkv_scan_bwd_du(Params p) {
  const int e = blockIdx.x * NT + threadIdx.x, n = p.nh * p.hd;
  if (e >= n) return;
  float s = 0.0f;
  for (int bc = 0; bc < p.B * p.nc; ++bc) s += p.dupart[(size_t)bc * n + e];
  p.du[e] = s;
}

template <typename T>
constexpr size_t state_smem() {
  return NSB * HM * 8 + (NSB + 3 + NSB + NSB) * HM * 4 + (size_t)QM * HLD * 4
      + (size_t)NTILE * SB * 24 * 4 + 2 * (size_t)3 * QM * TILE_LD * 2
      + 2 * (size_t)terms<T>() * QM * TILE_LD * 2;
}
template <typename T>
constexpr size_t chunk_smem() {
  return NSB * HM * 8 + (NSB + 3 + NSB + 2 * NSB + 1) * HM * 4 + 2 * QM * 4
      + 2 * NSB * 128 * 4 + 2 * (size_t)QM * FLD * 4
      + 2 * (size_t)NTILE * SB * 20 * 4 + 3 * (size_t)3 * QM * TILE_LD * 2
      + 2 * (size_t)terms<T>() * QM * TILE_LD * 2;
}
static_assert(chunk_smem<float>() <= 232448, "wkv_scan_bwd_chunk fits an SM");
static_assert(state_smem<__nv_bfloat16>() <= 113 * 1024,
              "two wkv_scan_bwd_state blocks an SM in bf16");

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  const dim3 grid(p.nh, p.nc, p.B);
  cudaError_t e = launch_opt_in<wkv_scan_bwd_state<T>>(
      grid, NT, state_smem<T>(), state_smem<T>(), p, stream);
  if (e != cudaSuccess) return e;
  wkv_scan_bwd_pass<<<dim3((p.hd * p.hd + 4 * NT - 1) / (4 * NT),
                           p.B * p.nh), NT, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_opt_in<wkv_scan_bwd_chunk<T>>(grid, NT, chunk_smem<T>(),
                                           chunk_smem<T>(), p, stream);
  if (e != cudaSuccess) return e;
  wkv_scan_bwd_du<<<(p.nh * p.hd + NT - 1) / NT, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v, dy, dr, dk, dv): 0 = float32, 1 = bfloat16. dsT and
// ds0 may be null. dstate, decay and dupart are the wrapper's fp32
// scratch of (B, nh, S / Q, hd, hd), (B, nh, S / Q, hd) and (B, S / Q, nh,
// hd) floats. Returns the first CUDA error of the four launches (0 on
// success); the wrapper raises on anything else. The wrapper has checked
// Q <= 64, hd <= 64, S % Q == 0.
extern "C" int wkv_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* dy,
    const void* logw, const void* u, const void* states, const void* dsT,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,
    void* dstate, void* decay, void* dupart, int dtype, int B, int S,
    int nh, int hd, int Q, void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{r, k, v, dy, static_cast<const float*>(logw),
           static_cast<const float*>(u), static_cast<const float*>(states),
           static_cast<const float*>(dsT), dr, dk, dv,
           static_cast<float*>(dlogw), static_cast<float*>(du),
           static_cast<float*>(ds0), static_cast<float*>(dstate),
           static_cast<float*>(decay), static_cast<float*>(dupart), B, S, nh,
           hd, Q, S / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
