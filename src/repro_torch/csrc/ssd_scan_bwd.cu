// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for sm_90a.
//
// No TPU kernel: the reference differentiates its jnp chunked scan
// `ssd_chunk_scan` (src/repro/models/ssm.py:75) with jax.grad. This is
// the backward of the `torch.autograd.Function` in
// kernels/ssd_scan/ops.py, whose forward is the ssd_scan kernel. Its
// oracle is `ref.py::ssd_scan_bwd_ref`. With the forward
//   h_t = e^{a_t} h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t + D x_t,
//   a_t = A dt_t, A = -exp(A_log), h_{-1} = 0,
// the gradients of sum(y dy) + sum(h_T d h_T) (d h_T zeros when h_T
// carries no gradient).
//
// Inputs: x, dy (Bb, S, nh, hd) and B, C (Bb, S, ds) of one dtype (fp32
// or bf16; B and C share their strides, unit channel stride), dt (Bb, S,
// nh), A_log and D (nh,) fp32, the forward's chunk scratch `states` (Bb,
// nh, S / Q, hd, ds) fp32, which its state pass leaves holding h_{c-1},
// the state entering chunk c; d h_T (Bb, nh, hd, ds) fp32 or null.
// Outputs: dx of x's dtype, dB and dC (Bb, S, ds) contiguous of x's
// dtype, ddt (Bb, S, nh), dA_log and dD (nh,) fp32. S is a multiple of
// the chunk Q <= 128 (ops.py pads), hd, ds <= 64. Scratch, the wrapper's,
// all fp32: dstate (Bb, nh, S / Q, hd, ds), decay (Bb, nh, S / Q), the
// per-head parts of dB and dC (Bb, nh, S, ds) each, three per-step sums
// (3, Bb, nh, S) and the per-chunk parts of dA_log and dD (Bb, S / Q,
// nh) each; the kernels allocate nothing.
//
// The chunked form. Per chunk of Q steps, cum_i = sum_{t <= i} a_t over
// the chunk, dH_c the gradient of the state the chunk leaves (d h_T for
// the last) and G_i the gradient of h_i:
//   G_i = sum_{k >= i} e^{cum_k - cum_i} dy_k C_k^T + e^{cum_Q - cum_i} dH_c
//   dH_{c-1} = e^{cum_Q} dH_c + ds_c,  ds_c = sum_k e^{cum_k} dy_k C_k^T
// (cum_Q the chunk's last cum). Each of dx, dB and dC is then one shape,
//   out_r = sum_{pairs m} (U_r . W_m) f(r, m) Z_m + (U_r . W_r) f_rr Z_r
//           + g(r) U_r H,
// the pairs m > r for dx and dB and m < r for dC:
//   dx_i / dt_i - D dy_i / dt_i: U, W, Z, H = B, C, dy, dH_c^T,
//        f = e^{cum_m - cum_i}, f_rr = 1, g = e^{cum_Q - cum_i} (G_i B_i);
//   dB_i (a head's part): U, W, Z, H = x, dy, C, dH_c,
//        f = e^{cum_m - cum_i} dt_i, f_rr = dt_i, g = dt_i e^{cum_Q - cum_i};
//   dC_k (a head's part): U, W, Z, H = dy, x, B, h_{c-1},
//        f = e^{cum_k - cum_m} dt_m, f_rr = dt_k, g = e^{cum_k}.
// ddt_t = x_t . G_t B_t + A da_t, and da_t = e^{a_t} <G_t, h_{t-1}>
// holds, in chunked form, the terms whose exponent holds a_t:
//   da_t = sum_{j < t <= i} T_ij + sum_{i >= t} C_i . dC_h,i
//          + sum_{j < t} dt_j x_j . dx_h,j + e^{cum_Q} <dH_c, h_{c-1}>,
//   T_ij = (dy_i . x_j) (C_i . B_j) e^{cum_i - cum_j} dt_j,
// dC_h and dx_h the g(r) U_r H parts. The pair sums are taken over the
// pairs themselves, a row's prefix over j and then a column's sum over i:
// a suffix sum of row sums minus column sums would give the same da_t as
// a difference of terms that add and take away each pair, whose rounding
// dA_log = A sum dt da (summed over every step) multiplies by about Q / 2
// (`_ssd_bwd_emulated` in tests/test_torch_scans.py holds this form
// within 1e-5 of float64 at a log decay of -18 a step; the suffix-sum form
// did not hold it). The pairs r = m and the chunk state's last step,
// whose exponents are 0, count in no sum of da.
//
// Every exponent is <= 0: e^{cum_i - cum_j} with j <= i, e^{cum_Q -
// cum_j} and e^{cum_j}; cum is summed in double and a difference of two
// cums is taken from the float pair hi + lo, as the forward takes it.
//
// What bounds it. At a zamba2-7b training batch, (4, 2048, 112, 64, 64)
// bf16, no d h_T, the function reads x, dy, dt and B, C and writes dx,
// ddt, dB and dC (A_log, D and their gradients are 1.8 KB): 363,857,664
// bytes, 0.1086 ms at 3.35 TB/s. Its least work is twice the forward's
// (each product takes two backward), 0.097 ms on the bf16 tensor cores at
// 3 bf16 terms a product with an fp32 factor. So it is bound by bytes
// (chip_smoke.py's ssd_bwd_cost computes this bound). The forward's chunk
// states are this design's choice, so they count below, not here.
//
// What this design moves beyond that, and why. A simple first design,
// seven kernels a call, all named ssd_scan_bwd_*, chunk-parallel (a block
// of 256 threads per (batch, head, chunk), 112 x 16 x 2 = 3584 at a
// microbatch):
//  1. ssd_scan_bwd_state: ds_c on the tensor cores (the forward's chunk
//     state kernel with dy, C and e^{cum_k}) and the chunk's decay.
//  2. ssd_scan_bwd_pass, per (batch, head): dH_c from d h_T (or zeros)
//     down the chunks, overwriting each ds_c, the next 8 chunks' loads in
//     flight while 8 are applied.
//  3. ssd_scan_bwd_chunk<MODE>, three launches (dx, dB, dC) of one
//     template: U, W and Z staged as bf16 term tiles and H as 3; each
//     warp takes the rows of two 16-row blocks (one from each end of the
//     causal triangle, so every warp does the same number of pairs), and
//     for each 16 x 16 pair block forms U W^T in registers, scales it by
//     its factors, splits it into 3 bf16 terms in place (the accumulator
//     of one mma.sync is the A fragment of the next) and multiplies Z;
//     then g(r) U H. dx is written in its dtype; dB's and dC's per-head
//     parts and the per-step sums x . dx', x . dx_h and C . dC_h in fp32.
//     Two blocks an SM in bf16 (a block an SM in fp32).
//  4. ssd_scan_bwd_da: T of the chunk's causal half (dy x^T and C B^T in
//     registers, one after the other on the same smem), its pair sums,
//     e^{cum_Q} <dH_c, h_{c-1}>, the prefix and suffix sums in double, ddt,
//     and the chunk's parts of dA_log and dD (its rows x . dy in double).
//  5. ssd_scan_bwd_sum: dB and dC summed over the heads in a fixed order
//     in double, dA_log and dD over (batch, chunk).
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits. Its own traffic beyond the function's bytes, at a microbatch: the
// forward's chunk states h_{c-1} (59 MB) are read by 3 (dC) and 4; the
// chunk kernels read x and dy (59 MB each) five times between them and 4
// once more; dstate (59 MB) is
// written by 1, read and written by 2 and read by 3 (dx, dB) and 4; the
// per-head parts of dB and dC (235 MB) are written by 3 and read by 5:
// about 1.4 GB, a floor near 0.4 ms.
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). x, dy, B and
// C are exact bf16 operands (fp32 ones split into 3 bf16 terms); every
// fp32 factor (the scaled pair blocks, dH_c, h_{c-1}, e^{cum_k} dy) is
// split into 3 bf16 terms, and the products of terms i, j with i + j <= 2
// are kept, each k step's into a zeroed accumulator that is then added to
// the fp32 total (common.cuh).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads a block: 8 warps
constexpr int QM = 128, HM = 64, DM = 64;  // chunk, hd and ds maxima
constexpr int LD = TILE_LD;              // bf16 row of 64 + 8
constexpr int TLD = QM + 1;              // fp32 rows of T, walked by row
constexpr int DX = 0, DB = 1, DC = 2;    // the chunk kernel's modes
static_assert(NT >= QM, "the da kernel takes a chunk's row a thread");

struct Params {
  const void* x;
  const float* dt;
  const float* A_log;
  const void* B;
  const void* C;
  const float* D;
  const float* states;   // (Bb, nh, nc, hd, ds): h_{c-1}
  const void* dy;
  const float* dhT;      // nullptr: zeros
  void* dx;
  float* ddt;
  float* dA_log;
  void* dB;              // (Bb, S, ds) contiguous
  void* dC;
  float* dD;
  float* dstate;         // (Bb, nh, nc, hd, ds): ds_c, then dH_c
  float* decay;          // (Bb, nh, nc): e^{cum_Q}
  float* dBpart;         // (Bb, nh, S, ds)
  float* dCpart;
  float* rows;           // (3, Bb, nh, S): x . dx', x . dx_h, C . dC_h
  float* dApart;         // (Bb, nc, nh): sum dt da
  float* dDpart;         // (Bb, nc, nh): sum x . dy
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

// v[i] replaced by its inclusive prefix sum over the QM steps (suffix sum
// with `rev`), in double, by warp 0.
__device__ void warp_scan(double* v, bool rev) {
  const int l = threadIdx.x;
  if (l >= 32) return;
  double x[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = rev ? QM - 1 - (4 * l + e) : 4 * l + e;
    run += v[i];
    x[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, tot, off);
    if (l >= off) tot += n;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[rev ? QM - 1 - (4 * l + e) : 4 * l + e] = tot - run + x[e];
}

// The block's sum of v (NT threads) in a fixed order, in double; every
// thread returns it. `red` holds NT doubles.
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

__device__ void load_dt(float* dts, const Params& p, int b, int h, int t0) {
  for (int i = threadIdx.x; i < QM; i += NT)
    dts[i] = i < p.Q ? p.dt[((size_t)b * p.S + t0 + i) * p.nh + h] : 0.0f;
}

// exp(cum_i - cum_j) for j <= i (an exponent <= 0), cum as the float pair
// hi + lo (ssd_scan.cu's decay).
__device__ __forceinline__ float decay(const float* hi, const float* lo,
                                       int i, int j) {
  return __expf((hi[i] - hi[j]) + (lo[i] - lo[j]));
}

// Element (i, k) of a staged K-term tile, as a float.
template <int K>
__device__ __forceinline__ float term_at(const __nv_bfloat16* s, int i,
                                         int k) {
  float v = 0.0f;
#pragma unroll
  for (int t = K - 1; t >= 0; --t)
    v += __bfloat162float(s[t * QM * LD + i * LD + k]);
  return v;
}

// acc (16 x 16, columns 8 n..) = rows 16 rb of Us times rows 16 mb of Ws
// transposed, over `ksteps` k steps of 16, both staged in K terms: the
// products of terms i + j <= 2, each k step's summed apart first.
template <int K>
__device__ __forceinline__ void pair_tile(float (&acc)[2][4],
                                          const __nv_bfloat16* Us,
                                          const __nv_bfloat16* Ws, int rb,
                                          int mb, int ksteps) {
  const int lane = threadIdx.x % 32;
  for (int ks = 0; ks < ksteps; ++ks) {
    float st[2][4] = {};
    uint32_t a[K][4], bt[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ldsm_x4(a[k], smem_u32(Us + k * QM * LD + a_lane(rb * 16, ks * 16, lane)));
      ldsm_x4(bt[k], smem_u32(Ws + k * QM * LD + bt_lane(mb * 16, ks * 16, lane)));
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
}

// 1. ds_c = sum_k e^{cum_k} dy_k C_k^T of one (batch, head, chunk), and
// the chunk's decay e^{cum_Q}: ssd_scan.cu's chunk-state kernel with dy,
// C and w_k = e^{cum_k}.
template <typename T>
__global__ void __launch_bounds__(NT, 4) ssd_scan_bwd_state(Params p) {
  constexpr int K = terms<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + QM);
  float* w = dts + QM;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(w + QM);
  __nv_bfloat16* Ys = Cs + K * QM * LD;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int tid = threadIdx.x;
  const float A = -expf(p.A_log[h]);
  {
    Tile<QM, T> ct(static_cast<const T*>(p.C) + (size_t)b * p.bc_bstride
                   + (size_t)t0 * p.bc_tstride, p.bc_tstride, p.Q, p.ds);
    Tile<QM, T> yt(static_cast<const T*>(p.dy)
                   + ((size_t)b * p.S + t0) * p.nh * p.hd + (size_t)h * p.hd,
                   (size_t)p.nh * p.hd, p.Q, p.hd);
    load_dt(dts, p, b, h, t0);
    ct.template store_terms<K>(Cs);
    yt.template store_terms<K>(Ys);
  }
  __syncthreads();
  chunk_cumsum(cum, dts, A);
  __syncthreads();
  for (int j = tid; j < QM; j += NT) w[j] = j < p.Q ? expf((float)cum[j]) : 0.0f;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + c;
  if (tid == 0) p.decay[bhc] = expf((float)cum[QM - 1]);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int d0 = (warp % 4) * 16, s0 = (warp / 4) * 32;
  if (d0 >= p.hd || s0 >= p.ds) return;
  float acc[4][4] = {};
  for (int ks = 0; ks < (p.Q + 15) / 16; ++ks) {
    float st[4][4] = {};
    // A (d, k) = w_k dy_k[d]: rows d0 + g (+8), cols ks 16 + 2t (+8)
    float ya[4][2] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t r[4];
      ldsm_x4_trans(r, smem_u32(Ys + k * QM * LD + bt_lane(ks * 16, d0, lane)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
        ya[q][0] += __low2float(v);
        ya[q][1] += __high2float(v);
      }
    }
    uint32_t a[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = ks * 16 + 2 * t + (q >> 1) * 8;
      split_pack<3>(w[j] * ya[q][0], w[j + 1] * ya[q][1], a[q]);
    }
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      uint32_t bb[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
        ldsm_x4_trans(bb[n2], smem_u32(Cs + j * QM * LD
                                       + b_lane(ks * 16, s0 + 16 * n2, lane)));
      mma_terms(st, a, bb, 2 - j);
    }
    add_to(acc, st);
  }
  float* out = p.dstate + bhc * p.hd * p.ds;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + g + (e >> 1) * 8, s = s0 + n * 8 + 2 * t + (e & 1);
      if (d < p.hd && s < p.ds) out[d * p.ds + s] = acc[n][e];
    }
}

// 2. dH_{c-1} = e^{cum_Q,c} dH_c + ds_c from d h_T (or zeros) down the
// chunks of one (batch, head), 4 elements of hd x ds a thread with 8
// chunks' loads in flight; ds_c is overwritten by dH_c.
__global__ void __launch_bounds__(NT) ssd_scan_bwd_pass(Params p) {
  const int n = p.hd * p.ds, e0 = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e0 >= n) return;
  const int m = min(4, n - e0);
  const bool vec = n % 4 == 0;       // every run of 4 is 16-byte aligned
  const size_t bh = blockIdx.y;
  float* __restrict__ st = p.dstate + bh * p.nc * n + e0;
  const float* __restrict__ dec = p.decay + bh * p.nc;
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (p.dhT != nullptr)
    for (int e = 0; e < m; ++e) h[e] = p.dhT[bh * n + e0 + e];
  for (int c0 = p.nc - 1; c0 >= 0; c0 -= 8) {
    float s[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* src = st + (size_t)(c0 - k) * n;
      if (c0 - k >= 0 && vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[k][0] = v.x, s[k][1] = v.y, s[k][2] = v.z, s[k][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[k][e] = c0 - k >= 0 && e < m ? src[e] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 - k < 0) break;
      float* dst = st + (size_t)(c0 - k) * n;
      const float a = __ldg(dec + c0 - k);
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
        for (int e = 0; e < m; ++e) dst[e] = h[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = h[e] * a + s[k][e];
    }
  }
}

// 3. One of dx, dB's and dC's per-head parts for one (batch, head,
// chunk), with its per-step sums (the header's out_r). Warp w owns two
// units of 16 rows x 32 columns of out, rows 16 w with columns 0..31 and
// rows 16 (7 - w) with columns 32..63.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT, 2) ssd_scan_bwd_chunk(Params p) {
  constexpr int K = terms<T>();
  constexpr bool LATER = MODE != DC;     // pairs m > r, else m < r
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + QM);
  float* chi = dts + QM;     // cum as the float pair chi + clo
  float* clo = chi + QM;
  float* gf = clo + QM;      // g(r)
  float* pd = gf + QM;       // U_r . W_r
  float* part = pd + QM;     // (2 sums, 2 column halves, QM)
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(part + 4 * QM);
  __nv_bfloat16* Ws = Us + K * QM * LD;
  __nv_bfloat16* Zs = Ws + K * QM * LD;
  __nv_bfloat16* Hs = Zs + K * QM * LD;   // 3 terms, HM x LD: rows d, cols s
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int tid = threadIdx.x;
  const float A = -expf(p.A_log[h]);
  const size_t row = (size_t)p.nh * p.hd;               // token stride of x
  const size_t xh = ((size_t)b * p.S + t0) * row + (size_t)h * p.hd;
  const size_t bc0 = (size_t)b * p.bc_bstride + (size_t)t0 * p.bc_tstride;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + c;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(p.dy);
  const T* Bm = static_cast<const T*>(p.B);
  const T* Cm = static_cast<const T*>(p.C);
  const int KU = MODE == DX ? p.ds : p.hd;   // width of U and W
  const int NZ = MODE == DX ? p.hd : p.ds;   // width of Z and of out
  {   // every load of the block in flight before any is used
    const size_t urs = MODE == DX ? (size_t)p.bc_tstride : row;
    const size_t zrs = MODE == DX ? row : (size_t)p.bc_tstride;
    Tile<QM, T> ut(MODE == DX ? Bm + bc0 : MODE == DB ? X + xh : DY + xh,
                   urs, p.Q, KU);
    Tile<QM, T> wt(MODE == DX ? Cm + bc0 : MODE == DB ? DY + xh : X + xh,
                   urs, p.Q, KU);
    Tile<QM, T> zt(MODE == DX ? DY + xh : MODE == DB ? Cm + bc0 : Bm + bc0,
                   zrs, p.Q, NZ);
    Tile<HM, float> ht((MODE == DC ? p.states : p.dstate)
                       + bhc * p.hd * p.ds, p.ds, p.hd, p.ds);
    load_dt(dts, p, b, h, t0);
    for (int i = tid; i < 4 * QM; i += NT) part[i] = 0.0f;
    ut.template store_terms<K>(Us);
    wt.template store_terms<K>(Ws);
    zt.template store_terms<K>(Zs);
    ht.template store_terms<3>(Hs);
  }
  __syncthreads();
  chunk_cumsum(cum, dts, A);
  __syncthreads();
  const double cQ = cum[QM - 1];
  for (int i = tid; i < QM; i += NT) {
    chi[i] = (float)cum[i];
    clo[i] = (float)(cum[i] - (double)chi[i]);
    const float eq = expf((float)(cQ - cum[i]));
    gf[i] = MODE == DX ? eq : MODE == DB ? dts[i] * eq : expf((float)cum[i]);
    float s = 0.0f;
    for (int k = 0; k < KU; ++k) s += term_at<K>(Us, i, k) * term_at<K>(Ws, i, k);
    pd[i] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int nrb = (p.Q + 15) / 16, ksteps = (KU + 15) / 16;
  const float Dh = p.D[h];
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    const int rb = u == 0 ? warp : 7 - warp, n0 = u * 32;
    if (rb >= nrb || n0 >= NZ) continue;
    float yi[4][4] = {}, ye[4][4] = {};
    const int m_lo = LATER ? rb : 0, m_hi = LATER ? nrb - 1 : rb;
    for (int mb = m_lo; mb <= m_hi; ++mb) {
      float pp[2][4] = {};
      pair_tile<K>(pp, Us, Ws, rb, mb, ksteps);
      // the pair block scaled by f(r, m), split into 3 terms in place:
      // fragment q holds rows g (+8 for odd q), columns 2t (+8 for q >= 2)
      uint32_t a[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = rb * 16 + g + (q & 1) * 8;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mb * 16 + (q >> 1) * 8 + 2 * t + e;
          float f;
          if (MODE == DX) f = m > i ? decay(chi, clo, m, i) : 0.0f;
          else if (MODE == DB) f = m > i ? decay(chi, clo, m, i) * dts[i] : 0.0f;
          else f = m < i ? decay(chi, clo, i, m) * dts[m] : 0.0f;
          v[e] = f * pp[q >> 1][(q & 1) * 2 + e];
        }
        split_pack<3>(v[0], v[1], a[q]);
      }
      float st[4][4] = {};
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        uint32_t bb[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldsm_x4_trans(bb[n2], smem_u32(Zs + j * QM * LD
                                         + b_lane(mb * 16, n0 + 16 * n2,
                                                  lane)));
        mma_terms(st, a, bb, 2 - j);
      }
      add_to(yi, st);
    }
    // U H: A = U (K terms), B = H (3 terms): H^T stored for dx (rows n =
    // d, cols k = s), H for dB and dC (rows k = d, cols n = s)
    for (int ks = 0; ks < ksteps; ++ks) {
      float st[4][4] = {};
      uint32_t a[K][4];
#pragma unroll
      for (int i = 0; i < K; ++i)
        ldsm_x4(a[i], smem_u32(Us + i * QM * LD + a_lane(rb * 16, ks * 16, lane)));
#pragma unroll
      for (int j = 2; j >= 0; --j) {
        uint32_t bt[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          if (MODE == DX)
            ldsm_x4(bt[n2], smem_u32(Hs + j * HM * LD
                                     + bt_lane(n0 + 16 * n2, ks * 16, lane)));
          else
            ldsm_x4_trans(bt[n2], smem_u32(Hs + j * HM * LD
                                           + b_lane(ks * 16, n0 + 16 * n2,
                                                    lane)));
        }
#pragma unroll
        for (int i = (K - 1 < 2 - j ? K - 1 : 2 - j); i >= 0; --i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(st[n], a[i], bt[n / 2][(n % 2) * 2],
                     bt[n / 2][(n % 2) * 2 + 1]);
      }
      add_to(ye, st);
    }
    // out, and the per-step sums over this unit's 32 columns
    float r1[2] = {0.0f, 0.0f}, r2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rb * 16 + g + (e >> 1) * 8;
        const int col = n0 + n * 8 + 2 * t + (e & 1);
        if (i >= p.Q || col >= NZ) continue;
        const float z = term_at<K>(Zs, i, col);
        const float strict = yi[n][e], inter = gf[i] * ye[n][e];
        const float v = (strict + inter)
            + pd[i] * (MODE == DX ? 1.0f : dts[i]) * z;
        if (MODE == DX) {
          const size_t at = xh + (size_t)i * row + col;
          store(static_cast<T*>(p.dx), at, dts[i] * v + Dh * z);
          const float xv = load(X, at);
          r1[e >> 1] += xv * strict;
          r2[e >> 1] += xv * inter;
        } else {
          const size_t at = (((size_t)b * p.nh + h) * p.S + t0 + i) * p.ds + col;
          (MODE == DB ? p.dBpart : p.dCpart)[at] = v;
          if (MODE == DC)
            r2[e >> 1] += load(Cm, bc0 + (size_t)i * p.bc_tstride + col) * inter;
        }
      }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        r1[k] += __shfl_xor_sync(0xffffffffu, r1[k], off);
        r2[k] += __shfl_xor_sync(0xffffffffu, r2[k], off);
      }
    if (t == 0)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = rb * 16 + g + k * 8;
        part[(0 * 2 + u) * QM + i] = r1[k];
        part[(1 * 2 + u) * QM + i] = r2[k];
      }
  }
  if (MODE == DB) return;
  __syncthreads();
  const size_t plane = (size_t)p.Bb * p.nh * p.S;
  const size_t at = ((size_t)b * p.nh + h) * p.S + t0;
  for (int i = tid; i < p.Q; i += NT) {
    const float s1 = part[i] + part[QM + i];
    const float s2 = part[2 * QM + i] + part[3 * QM + i];
    if (MODE == DX) {
      p.rows[at + i] = s1;
      p.rows[plane + at + i] = s2;
    } else {
      p.rows[2 * plane + at + i] = s2;
    }
  }
}

// 4. da of one (batch, head, chunk) and what follows from it: T's pair
// sums (dy x^T and C B^T of the causal half in registers, one after the
// other on the same shared memory), e^{cum_Q} <dH_c, h_{c-1}>, the prefix
// and suffix sums, ddt, and the chunk's parts of dA_log and dD.
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_scan_bwd_da(Params p) {
  constexpr int K = terms<T>();
  constexpr int MAXT = 5;                // tiles a warp: 36 in 8 warps
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  double* su = cum + QM;     // C . dC_h, then its suffix sums
  double* pr = su + QM;      // dt x . dx_h, then its prefix sums
  double* red = pr + QM;     // NT
  float* dts = reinterpret_cast<float*>(red + NT);
  float* chi = dts + QM;
  float* clo = chi + QM;
  float* xdy = clo + QM;     // x_i . dy_i
  float* bcd = xdy + QM;     // B_i . C_i
  float* Ts = bcd + QM;      // QM x TLD: T, then its rows' prefix sums
  __nv_bfloat16* P0 = reinterpret_cast<__nv_bfloat16*>(Ts + QM * TLD);
  __nv_bfloat16* P1 = P0 + K * QM * LD;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int tid = threadIdx.x;
  const float A = -expf(p.A_log[h]);
  const size_t row = (size_t)p.nh * p.hd;
  const size_t xh = ((size_t)b * p.S + t0) * row + (size_t)h * p.hd;
  const size_t bc0 = (size_t)b * p.bc_bstride + (size_t)t0 * p.bc_tstride;
  const size_t bhc = ((size_t)b * p.nh + h) * p.nc + c;
  {
    Tile<QM, T> yt(static_cast<const T*>(p.dy) + xh, row, p.Q, p.hd);
    Tile<QM, T> xt(static_cast<const T*>(p.x) + xh, row, p.Q, p.hd);
    load_dt(dts, p, b, h, t0);
    yt.template store_terms<K>(P0);
    xt.template store_terms<K>(P1);
  }
  __syncthreads();
  chunk_cumsum(cum, dts, A);
  __syncthreads();
  // x_i . dy_i in double: ddt's pair i = i and the row sums of dD, which
  // sums terms of both signs, so an fp32 sum over hd would show in it
  // (fp32 dD read 7.2e-7 of float64 with one). The staged terms sum to x
  // and dy exactly (3 bf16 terms hold an fp32's 24 bits), so each product
  // is exact in double. NT >= QM: a thread a row, which it keeps for dD.
  double xd_row = 0.0;
  for (int i = tid; i < QM; i += NT) {
    chi[i] = (float)cum[i];
    clo[i] = (float)(cum[i] - (double)chi[i]);
    for (int k = 0; k < p.hd; ++k)
      xd_row += (double)term_at<K>(P0, i, k) * term_at<K>(P1, i, k);
    xdy[i] = (float)xd_row;
  }
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int nrb = (p.Q + 15) / 16, ntile = nrb * (nrb + 1) / 2;
  auto tile_rc = [](int tile, int& rb, int& cb) {
    rb = 0;
    while ((rb + 1) * (rb + 2) / 2 <= tile) ++rb;
    cb = tile - rb * (rb + 1) / 2;
  };
  float xd[MAXT][2][4];
#pragma unroll
  for (int q = 0; q < MAXT; ++q) {
    const int tile = warp + 8 * q;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xd[q][n][e] = 0.0f;
    if (tile < ntile) {
      int rb, cb;
      tile_rc(tile, rb, cb);
      pair_tile<K>(xd[q], P0, P1, rb, cb, (p.hd + 15) / 16);
    }
  }
  __syncthreads();
  {
    Tile<QM, T> ct(static_cast<const T*>(p.C) + bc0, p.bc_tstride, p.Q, p.ds);
    Tile<QM, T> bt(static_cast<const T*>(p.B) + bc0, p.bc_tstride, p.Q, p.ds);
    ct.template store_terms<K>(P0);
    bt.template store_terms<K>(P1);
  }
  __syncthreads();
  for (int i = tid; i < QM; i += NT) {
    float s = 0.0f;
    for (int k = 0; k < p.ds; ++k) s += term_at<K>(P0, i, k) * term_at<K>(P1, i, k);
    bcd[i] = s;
  }
#pragma unroll
  for (int q = 0; q < MAXT; ++q) {
    const int tile = warp + 8 * q;
    if (tile < ntile) {
      int rb, cb;
      tile_rc(tile, rb, cb);
      float cbt[2][4] = {};
      pair_tile<K>(cbt, P0, P1, rb, cb, (p.ds + 15) / 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rb * 16 + g + (e >> 1) * 8;
          const int j = cb * 16 + n * 8 + 2 * t + (e & 1);
          Ts[i * TLD + j] = j < i
              ? (xd[q][n][e] * cbt[n][e]) * decay(chi, clo, i, j) * dts[j]
              : 0.0f;
        }
    }
  }
  __syncthreads();
  if (tid < p.Q) {   // row i: T's prefix over j < t, for t <= i, in place
    double run = 0.0;
    for (int j = 0; j <= tid; ++j) {
      const float v = Ts[tid * TLD + j];
      Ts[tid * TLD + j] = (float)run;
      run += v;
    }
  }
  // e^{cum_Q} <dH_c, h_{c-1}>, in a fixed order
  double e = 0.0;
  {
    const float* dH = p.dstate + bhc * p.hd * p.ds;
    const float* hp = p.states + bhc * p.hd * p.ds;
    for (int k = tid; k < p.hd * p.ds; k += NT) e += (double)dH[k] * hp[k];
  }
  const double E = (double)expf((float)cum[QM - 1]) * block_sum(e, red);
  const size_t plane = (size_t)p.Bb * p.nh * p.S;
  const size_t at = ((size_t)b * p.nh + h) * p.S + t0;
  float s0 = 0.0f, s1 = 0.0f;
  double da = 0.0;
  if (tid < QM) {
    const bool in = tid < p.Q;
    s0 = in ? p.rows[at + tid] : 0.0f;
    s1 = in ? p.rows[plane + at + tid] : 0.0f;
    su[tid] = in ? (double)p.rows[2 * plane + at + tid] : 0.0;
    pr[tid] = (double)dts[tid] * s1;
    for (int i = tid; i < p.Q; ++i) da += Ts[i * TLD + tid];   // i >= t
  }
  __syncthreads();
  if (warp == 0) {
    warp_scan(su, true);
    warp_scan(pr, false);
  }
  __syncthreads();
  double dtda = 0.0, xd_sum = 0.0;
  if (tid < p.Q) {
    da += su[tid] + (pr[tid] - (double)dts[tid] * s1) + E;
    p.ddt[((size_t)b * p.S + t0 + tid) * p.nh + h] =
        (float)((double)(s0 + s1 + bcd[tid] * xdy[tid]) + (double)A * da);
    dtda = (double)dts[tid] * da;
    xd_sum = xd_row;
  }
  const double sa = block_sum(dtda, red);
  const double sd = block_sum(xd_sum, red);
  if (tid == 0) {
    p.dApart[((size_t)b * p.nc + c) * p.nh + h] = (float)sa;
    p.dDpart[((size_t)b * p.nc + c) * p.nh + h] = (float)sd;
  }
}

// 5. dB and dC as the per-head parts summed over the heads in a fixed
// order, in double, a thread an element of (Bb, S, ds); and dA_log = A
// sum dt da and dD over (batch, chunk), a thread a head.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_sum(Params p) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t sd = (size_t)p.S * p.ds, n = (size_t)p.Bb * sd;
  if (e < n) {
    const size_t b = e / sd, rem = e % sd;
    double sb = 0.0, sc = 0.0;
    for (int h = 0; h < p.nh; ++h) {
      const size_t off = ((size_t)b * p.nh + h) * sd + rem;
      sb += p.dBpart[off];
      sc += p.dCpart[off];
    }
    store(static_cast<T*>(p.dB), e, (float)sb);
    store(static_cast<T*>(p.dC), e, (float)sc);
  }
  if (e < (size_t)p.nh) {
    double sa = 0.0, sdd = 0.0;
    for (int bc = 0; bc < p.Bb * p.nc; ++bc) {
      sa += p.dApart[(size_t)bc * p.nh + e];
      sdd += p.dDpart[(size_t)bc * p.nh + e];
    }
    p.dA_log[e] = (float)((double)-expf(p.A_log[e]) * sa);
    p.dD[e] = (float)sdd;
  }
}

constexpr size_t state_smem(int K) {
  return QM * 8 + 2 * QM * 4 + 2 * (size_t)K * QM * LD * 2;
}
constexpr size_t chunk_smem(int K) {
  return QM * 8 + 9 * QM * 4 + 3 * (size_t)K * QM * LD * 2
      + 3 * (size_t)HM * LD * 2;
}
constexpr size_t da_smem(int K) {
  return 3 * QM * 8 + NT * 8 + 5 * QM * 4 + (size_t)QM * TLD * 4
      + 2 * (size_t)K * QM * LD * 2;
}
static_assert(chunk_smem(3) <= 232448, "ssd_scan_bwd_chunk fits an SM in fp32");
static_assert(da_smem(3) <= 232448, "ssd_scan_bwd_da fits an SM in fp32");
static_assert(2 * chunk_smem(1) <= 233472 && 2 * da_smem(1) <= 233472,
              "two blocks an SM in bf16");

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int K = terms<T>();
  const dim3 grid(p.nc, p.nh, p.Bb);
  cudaError_t e = launch_opt_in<ssd_scan_bwd_state<T>>(
      grid, NT, state_smem(K), state_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  ssd_scan_bwd_pass<<<dim3((p.hd * p.ds + 4 * NT - 1) / (4 * NT),
                           p.Bb * p.nh), NT, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_bwd_chunk<T, DX>>(
      grid, NT, chunk_smem(K), chunk_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_bwd_chunk<T, DB>>(
      grid, NT, chunk_smem(K), chunk_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_bwd_chunk<T, DC>>(
      grid, NT, chunk_smem(K), chunk_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_bwd_da<T>>(grid, NT, da_smem(K), da_smem(K),
                                        p, stream);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)p.Bb * p.S * p.ds;
  const size_t m = n > (size_t)p.nh ? n : (size_t)p.nh;
  ssd_scan_bwd_sum<T><<<(unsigned)((m + NT - 1) / NT), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, dy, B, C, dx, dB, dC): 0 = float32, 1 = bfloat16. dhT may
// be null. dstate, decay, dBpart, dCpart, rows, dApart and dDpart are the
// wrapper's fp32 scratch of (Bb, nh, S / Q, hd, ds), (Bb, nh, S / Q),
// (Bb, nh, S, ds) twice, (3, Bb, nh, S) and (Bb, S / Q, nh) twice floats.
// Returns the first CUDA error of the seven launches (0 on success); the
// wrapper raises on anything else. The wrapper has checked Q <= 128, hd
// <= 64, ds <= 64, S % Q == 0.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* states, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dA_log, void* dB, void* dC,
    void* dD, void* dstate, void* decay, void* dBpart, void* dCpart,
    void* rows, void* dApart, void* dDpart, int dtype, int Bb, int S,
    int nh, int hd, int ds, int Q, long long bc_bstride,
    long long bc_tstride, void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || ds < 1 || ds > DM ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt),
           static_cast<const float*>(A_log), B, C,
           static_cast<const float*>(D), static_cast<const float*>(states),
           dy, static_cast<const float*>(dhT), dx,
           static_cast<float*>(ddt), static_cast<float*>(dA_log), dB, dC,
           static_cast<float*>(dD), static_cast<float*>(dstate),
           static_cast<float*>(decay), static_cast<float*>(dBpart),
           static_cast<float*>(dCpart), static_cast<float*>(rows),
           static_cast<float*>(dApart), static_cast<float*>(dDpart), Bb, S,
           nh, hd, ds, Q, S / Q, bc_bstride, bc_tstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
