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
// head groups' parts of dB and dC (Bb, ceil(nh / G), S, ds) each and the
// per-chunk parts of dA_log and dD (Bb, S / Q, nh) each; the kernels
// allocate nothing.
//
// The chunked form. Per chunk of Q steps, cum_i = sum_{t <= i} a_t over
// the chunk, dH_c the gradient of the state the chunk leaves (d h_T for
// the last) and G_i the gradient of h_i:
//   G_i = sum_{k >= i} e^{cum_k - cum_i} dy_k C_k^T + e^{cum_Q - cum_i} dH_c
//   dH_{c-1} = e^{cum_Q} dH_c + ds_c,  ds_c = sum_k e^{cum_k} dy_k C_k^T
// (cum_Q the chunk's last cum). With the pair matrices, for m >= r,
//   M_rm = x_r . dy_m,  P_rm = e^{cum_m - cum_r} dt_r M_rm,
//   R_rm = e^{cum_m - cum_r} (B_r . C_m),
// the three gradients of the chunk's inputs are products of P and R:
//   dx_r = dt_r dx'_r + D dy_r,  dx'_r = sum_{m >= r} R_rm dy_m
//          + e^{cum_Q - cum_r} dH_c B_r  (= G_r B_r);
//   dB_r = sum_{m >= r} P_rm C_m + dt_r e^{cum_Q - cum_r} x_r dH_c;
//   dC_k = sum_{m <= k} P_mk B_m + e^{cum_k} dy_k h_{c-1}
// (dB and dC summed over the heads). ddt_t = x_t . dx'_t + A da_t, and
// da_t = e^{a_t} <G_t, h_{t-1}> holds, in chunked form, the terms whose
// exponent holds a_t:
//   da_t = sum_{r < t <= m} P_rm (B_r . C_m) + sum_{i >= t} C_i . dC_h,i
//          + sum_{j < t} dt_j x_j . dx_h,j + e^{cum_Q} <dH_c, h_{c-1}>,
// dC_h and dx_h the terms of dC and dx' that hold dH_c or h_{c-1}. The
// pair sum is taken over the pairs themselves, never as a difference of
// sums that add and take away a pair, whose rounding dA_log = A sum dt da
// multiplies by about Q / 2 (`_ssd_bwd_emulated` in
// tests/test_torch_scans.py holds this form within 1e-5 of float64 at a
// log decay of -18 a step). The pairs r = m and the chunk state's last
// step, whose exponents are 0, count in no sum of da.
//
// Every exponent is <= 0: e^{cum_m - cum_r} with r <= m, e^{cum_Q -
// cum_r} and e^{cum_k}; cum is summed in double and a difference of two
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
// The design: four kernels a call, all named ssd_scan_bwd_*.
//  1. ssd_scan_bwd_state, a block per (batch, head, chunk): ds_c on the
//     tensor cores (the forward's chunk state kernel with dy, C and
//     e^{cum_k}) and the chunk's decay.
//  2. ssd_scan_bwd_pass, per (batch, head): dH_c from d h_T (or zeros)
//     down the chunks, overwriting each ds_c, the next 8 chunks' loads in
//     flight while 8 are applied.
//  3. ssd_scan_bwd_chunk, one fused block of 8 warps per (batch, chunk)
//     and a group of G <= 8 heads (the wrapper picks G, the last group
//     may be smaller; one block an SM): B and C are staged once, and dB
//     and dC summed over the group's heads in fp32 registers. For each
//     head, with the next head's x, dy and dt in flight through cp.async
//     (two stages in bf16) and its dH_c and h_{c-1} loading while this
//     head's da is finished:
//       a. warp 0: cum; the others: <dH_c, h_{c-1}> and sum x . dy (dD's
//          part) in double;
//       b. each of the 36 pair tiles (16 x 16, r <= m) once, 4 or 5 a
//          warp: M = x dy^T and C B^T on the tensor cores, the decays f
//          once, P = f dt_r M and (bf16) R = f C B^T kept in shared
//          memory, and the pair terms of da, P . (C B^T), summed on the
//          tile in double (the diagonal tile into 16 bins by a scattered
//          warp reduction, the others by rows, by columns and whole).
//          C B^T is formed again for each head (8 mma a tile): the space
//          a group-wide C B^T would take holds R, so that no tile of d
//          takes an exp (measured on the H100: the chunk kernel 0.93 ->
//          0.83 ms at a microbatch);
//       c. da's pair sum for every step from those tile sums, with warp
//          scans over each 16 steps (no pair is added and taken away);
//       d. the products by 16 x 32 units, a warp's two units the 16-row
//          blocks a and 7 - a of one half of the columns (9 pair tiles a
//          warp for dx and dB, and 9 for dC, whose units are P's columns):
//          R times dy (dx), P times C (dB) and P^T (transposed in
//          registers by movmatrix) times B (dC), then B dH_c^T, x dH_c
//          and dy h_{c-1} (the two units share each dH_c and h_{c-1}
//          fragment, split into 3 terms as it is read); dx is written,
//          the row sums x . dx' and C . dC_h kept for e;
//       e. the prefix and suffix sums of da in double (warp scans over 4
//          warps, which meet at two 128-thread barriers), ddt, and the
//          chunk's parts of dA_log and dD;
//     then the group's parts of dB and dC.
//  4. ssd_scan_bwd_sum: dB and dC summed over the head groups in a fixed
//     order in double, dA_log and dD over (batch, chunk).
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits. fp32 inputs run the same kernels: with 3-term operands, x, dy, B
// and C are staged as fp32 (one stage, loaded after the previous head)
// and split into 3 bf16 terms as each fragment is read, and d forms each
// R tile where it is used (there is no room for R).
// Its own traffic at a microbatch, (2, 2048, 112, 64, 64) bf16, G = 7:
// 1 reads dy and C and writes dstate (120 MB); 2 reads and writes dstate
// (117 MB); 3 reads x, dy, dstate and h_{c-1} and writes dx (59 MB each)
// and the groups' parts of dB and dC (34 MB); 4 reads those parts (35
// MB): about 0.60 GB, a floor near 0.18 ms (chip_smoke.py's
// ssd_bwd_design_bytes counts it by kernel).
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). x, dy, B and
// C are exact bf16 operands (fp32 ones split into 3 bf16 terms); every
// fp32 factor (P, R, dH_c, h_{c-1}, e^{cum_k} dy) is split into 3 bf16
// terms, and the products of terms i, j with i + j <= 2 are kept, each k
// step's into a zeroed accumulator that is then added to the fp32 total
// (common.cuh).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads a block: 8 warps
constexpr int QM = 128, HM = 64, DM = 64;  // chunk, hd and ds maxima
constexpr int LD = TILE_LD;              // bf16 row of 64 + 8
constexpr int NRB = QM / 16;             // 16-row blocks of a chunk
constexpr int NTILE = NRB * (NRB + 1) / 2, NOFF = NTILE - NRB;  // 36, 28
constexpr int GMAX = 8;                  // heads a chunk block at most
constexpr int HLD = 68;                  // fp32 row of dH_c and h_{c-1}
static_assert(NT / 32 == NRB, "a warp a 16-row block");
static_assert(NT >= QM, "the chunk kernel takes a step a thread");

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
  float* dBpart;         // (Bb, ng, S, ds)
  float* dCpart;
  float* dApart;         // (Bb, nc, nh): sum dt da
  float* dDpart;         // (Bb, nc, nh): sum x . dy
  int Bb, S, nh, hd, ds, Q, nc, G, ng;
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

// exp(cum_i - cum_j) for j <= i (an exponent <= 0), cum as the float pair
// hi + lo (ssd_scan.cu's decay).
__device__ __forceinline__ float decay(const float* hi, const float* lo,
                                       int i, int j) {
  return __expf((hi[i] - hi[j]) + (lo[i] - lo[j]));
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

// ---- 3. The fused chunk kernel ----

// 16-byte cp.async (src_bytes 0: 16 zero bytes), 4-byte cp.async, and
// their groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [0, n) x cols [0, m) of `src` (element (i, j) at i * rs + j) into
// the ROWS x 64 tile dst (row stride LDS elements), zeros elsewhere: a
// 16-byte cp.async for each whole, aligned run of 16 bytes, element loads
// for a ragged or unaligned one. Nothing waits here.
template <typename T, int LDS, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t rs,
                                      int n, int m) {
  constexpr int V = 16 / sizeof(T), RUNS = 64 / V;
  for (int idx = threadIdx.x; idx < ROWS * RUNS; idx += NT) {
    const int i = idx / RUNS, j = (idx % RUNS) * V;
    T* d = dst + i * LDS + j;
    const T* s = src + (size_t)i * rs + j;
    if (i >= n || j >= m) {
      cp_async16(d, src, 0);
    } else if (j + V <= m && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) store(d, e, j + e < m ? load(s, e) : 0.0f);
    }
  }
}

// Fragments of staged tiles (mma_bf16's layouts), K = terms<T>() bf16
// terms each: bf16 tiles (row stride TILE_LD) through ldmatrix, fp32 ones
// (row stride LDS) loaded and split into 3 terms. frag_a: the A fragment
// of rows r0.., cols c0..; frag_bt: two n8 B fragments whose n runs along
// rows n0.. and k along cols c0.. (B^T stored); frag_b: two n8 B
// fragments whose k runs along rows k0.. and n along cols n0.. (B stored).
template <typename T, int LDS>
__device__ __forceinline__ void frag_a(uint32_t (&a)[terms<T>()][4],
                                       const T* s, int r0, int c0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    static_assert(LDS == TILE_LD, "bf16 tiles have rows of TILE_LD");
    ldsm_x4(a[0], smem_u32(s + a_lane(r0, c0, lane)));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + (r0 + g + (q & 1) * 8) * LDS + c0 + 2 * t + (q >> 1) * 8);
      uint32_t r[3];
      split_pack<3>(v.x, v.y, r);
#pragma unroll
      for (int k = 0; k < 3; ++k) a[k][q] = r[k];
    }
  }
}
template <typename T, int LDS>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[terms<T>()][4],
                                        const T* s, int n0, int c0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    static_assert(LDS == TILE_LD, "bf16 tiles have rows of TILE_LD");
    ldsm_x4(b[0], smem_u32(s + bt_lane(n0, c0, lane)));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + (n0 + g + (q >> 1) * 8) * LDS + c0 + 2 * t + (q & 1) * 8);
      uint32_t r[3];
      split_pack<3>(v.x, v.y, r);
#pragma unroll
      for (int k = 0; k < 3; ++k) b[k][q] = r[k];
    }
  }
}
template <typename T, int LDS>
__device__ __forceinline__ void frag_b(uint32_t (&b)[terms<T>()][4],
                                       const T* s, int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    static_assert(LDS == TILE_LD, "bf16 tiles have rows of TILE_LD");
    ldsm_x4_trans(b[0], smem_u32(s + b_lane(k0, n0, lane)));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* e = s + (k0 + 2 * t + (q & 1) * 8) * LDS + n0 + g
          + (q >> 1) * 8;
      uint32_t r[3];
      split_pack<3>(e[0], e[LDS], r);
#pragma unroll
      for (int k = 0; k < 3; ++k) b[k][q] = r[k];
    }
  }
}

// st (16 x 16) += a b over the term products i + j <= 2, smallest first.
template <int KA, int KB>
__device__ __forceinline__ void mma16(float (&st)[2][4],
                                      const uint32_t (&a)[KA][4],
                                      const uint32_t (&b)[KB][4]) {
#pragma unroll
  for (int i = KA - 1; i >= 0; --i)
#pragma unroll
    for (int j = (KB - 1 < 2 - i ? KB - 1 : 2 - i); j >= 0; --j) {
      mma_bf16(st[0], a[i], b[j][0], b[j][1]);
      mma_bf16(st[1], a[i], b[j][2], b[j][3]);
    }
}
// st (16 x 32) += a [b0 b1], as mma16.
template <int KA, int KB>
__device__ __forceinline__ void mma32(float (&st)[4][4],
                                      const uint32_t (&a)[KA][4],
                                      const uint32_t (&b0)[KB][4],
                                      const uint32_t (&b1)[KB][4]) {
#pragma unroll
  for (int i = KA - 1; i >= 0; --i)
#pragma unroll
    for (int j = (KB - 1 < 2 - i ? KB - 1 : 2 - i); j >= 0; --j) {
      mma_bf16(st[0], a[i], b0[j][0], b0[j][1]);
      mma_bf16(st[1], a[i], b0[j][2], b0[j][3]);
      mma_bf16(st[2], a[i], b1[j][0], b1[j][1]);
      mma_bf16(st[3], a[i], b1[j][2], b1[j][3]);
    }
}

// acc (16 x 16) = rows 16 rb of U times rows 16 mb of W transposed, over
// `ksteps` k steps of 16, each step's products summed apart first.
template <typename T, int LDS>
__device__ __forceinline__ void pair(float (&acc)[2][4], const T* U,
                                     const T* W, int rb, int mb,
                                     int ksteps) {
  constexpr int K = terms<T>();
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[K][4], bt[K][4];
    frag_a<T, LDS>(a, U, rb * 16, ks * 16);
    frag_bt<T, LDS>(bt, W, mb * 16, ks * 16);
    float st[2][4] = {};
    mma16<K, K>(st, a, bt);
    add_to(acc, st);
  }
}

// The fp32 16 x 16 tile v (accumulator layout) split into 3 bf16 terms
// as an A fragment, term-major.
__device__ __forceinline__ void split_a(const float (&v)[2][4],
                                        uint32_t (&a)[3][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r[3];
    split_pack<3>(v[q >> 1][(q & 1) * 2], v[q >> 1][(q & 1) * 2 + 1], r);
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k][q] = r[k];
  }
}

// The 8 x 8 b16 matrix held as mma_bf16's A sub-fragment, transposed
// across the warp.
__device__ __forceinline__ uint32_t movT(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// A 16 x 16 fp32 tile in fragment order (lane-major float4s: no bank
// conflicts), tile k of `base`.
__device__ __forceinline__ void put_frag(float* base, int k,
                                         const float (&v)[2][4]) {
  float4* q = reinterpret_cast<float4*>(base) + k * 64 + threadIdx.x % 32;
  q[0] = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
  q[32] = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
}
__device__ __forceinline__ void get_frag(const float* base, int k,
                                         float (&v)[2][4]) {
  const float4* q = reinterpret_cast<const float4*>(base) + k * 64
      + threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float4 f = q[32 * n];
    v[n][0] = f.x, v[n][1] = f.y, v[n][2] = f.z, v[n][3] = f.w;
  }
}

// The pair tiles (rb, mb), rb <= mb, numbered by diagonal: the 8 tiles
// (r, r) first, then the 7 tiles (r, r + 1), and so on.
__host__ __device__ constexpr int tile_id(int rb, int mb) {
  return (mb - rb) * NRB - (mb - rb) * (mb - rb - 1) / 2 + rb;
}
__device__ __forceinline__ void tile_rc(int k, int& rb, int& mb) {
  int s = 0;
  while (k >= NRB - s) {
    k -= NRB - s;
    ++s;
  }
  rb = k;
  mb = k + s;
}

// The fused kernel's shared memory, byte offsets. Two stages of x, dy
// in bf16 (one in fp32: three-term operands are staged as fp32 and split
// as they are read), one of dH_c and h_{c-1}; P and R (bf16 only; fp32
// forms each R tile where it is used) as fragment-ordered tiles; the
// per-step vectors; the da tile sums.
template <typename T>
struct Smem {
  static constexpr int K = terms<T>(), LDS = sizeof(T) == 2 ? TILE_LD : 68,
      STG = sizeof(T) == 2 ? 2 : 1;
  static constexpr size_t TILE = (size_t)QM * LDS * sizeof(T),
      HT = (size_t)HM * HLD * 4, PT = (size_t)NTILE * 256 * 4;
  static constexpr size_t B = 0, C = B + TILE, X = C + TILE,
      DY = X + STG * TILE, DH = DY + STG * TILE, H = DH + HT, P = H + HT,
      R = P + PT, DT = R + (K == 1 ? PT : 0), CHI = DT + 2 * QM * 4,
      CLO = CHI + QM * 4, EQ = CLO + QM * 4, ECUM = EQ + QM * 4,
      PART = ECUM + QM * 4, BOX = PART + 6 * QM * 4,
      SFULL = BOX + NRB * 16 * 8, ROWT = SFULL + NOFF * 8,
      COLT = ROWT + NOFF * 16 * 4, DAIN = COLT + NOFF * 16 * 4,
      RED = DAIN + QM * 8, SCAL = RED + 28 * 8,
      TOTAL = SCAL + (1 + 2 * GMAX) * 4;
};
static_assert(Smem<__nv_bfloat16>::TOTAL <= 232448,
              "ssd_scan_bwd_chunk fits an SM in bf16");
static_assert(Smem<float>::TOTAL <= 232448,
              "ssd_scan_bwd_chunk fits an SM in fp32");

// cum over the chunk in double by warp 0 (lane l owns steps 4 l..4 l + 3)
// and what the chunk kernel takes from it: cum as the float pair chi +
// clo, e^{cum_Q - cum_i}, e^{cum_i} and e^{cum_Q}.
__device__ __forceinline__ void head_cum(const float* dts, float A,
                                         float* chi, float* clo, float* eQ,
                                         float* ecum, float* decQ) {
  const int l = threadIdx.x;
  double v[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += (double)dts[4 * l + e] * A;
    v[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, tot, off);
    if (l >= off) tot += n;
  }
  const double cQ = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * l + e;
    const double cum = tot - run + v[e];
    chi[i] = (float)cum;
    clo[i] = (float)(cum - (double)chi[i]);
    eQ[i] = expf((float)(cQ - cum));
    ecum[i] = expf((float)cum);
  }
  if (l == 0) *decQ = expf((float)cQ);
}

// A barrier of the chunk kernel's first QM threads (4 warps), the ones
// that take a step of the chunk each in step e.
__device__ __forceinline__ void bar_step() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(QM) : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 3. The chunk work of one (batch, chunk) and heads h0.. h0 + hn - 1 (a
// group of p.G, the last one ragged), a head at a time (the header's
// steps a-e), then the group's dB and dC parts (f).
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_bwd_chunk(Params p) {
  using L = Smem<T>;
  constexpr int K = L::K, LDS = L::LDS, STG = L::STG;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Bs = reinterpret_cast<T*>(smem + L::B);
  T* Cs = reinterpret_cast<T*>(smem + L::C);
  float* dHs = reinterpret_cast<float*>(smem + L::DH);
  float* hs = reinterpret_cast<float*>(smem + L::H);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* Rs = reinterpret_cast<float*>(smem + L::R);
  float* chi = reinterpret_cast<float*>(smem + L::CHI);
  float* clo = reinterpret_cast<float*>(smem + L::CLO);
  float* eQ = reinterpret_cast<float*>(smem + L::EQ);
  float* ecum = reinterpret_cast<float*>(smem + L::ECUM);
  float* part = reinterpret_cast<float*>(smem + L::PART);  // (2 halves, 3, QM)
  double* box = reinterpret_cast<double*>(smem + L::BOX);  // (NRB, 16)
  double* Sfull = reinterpret_cast<double*>(smem + L::SFULL);
  float* rowT = reinterpret_cast<float*>(smem + L::ROWT);  // (NOFF, 16)
  float* colT = reinterpret_cast<float*>(smem + L::COLT);
  double* dain = reinterpret_cast<double*>(smem + L::DAIN);
  // E 8, dD 8, the scans' warp totals 4 + 4, dA 4
  double* red = reinterpret_cast<double*>(smem + L::RED);
  // e^{cum_Q}, then A and D of each head of the group
  float* scal = reinterpret_cast<float*>(smem + L::SCAL);
  auto xs = [&](int n) {
    return reinterpret_cast<T*>(smem + L::X + (n % STG) * L::TILE);
  };
  auto dys = [&](int n) {
    return reinterpret_cast<T*>(smem + L::DY + (n % STG) * L::TILE);
  };
  auto dts = [&](int n) {
    return reinterpret_cast<float*>(smem + L::DT + (n % 2) * QM * 4);
  };

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, t0 = c * p.Q;
  const int h0 = grp * p.G, hn = min(p.G, p.nh - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)p.nh * p.hd;               // token stride of x
  const size_t bc0 = (size_t)b * p.bc_bstride + (size_t)t0 * p.bc_tstride;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(p.dy);
  const int hsteps = (p.hd + 15) / 16, dsteps = (p.ds + 15) / 16;

  auto load_head = [&](int n) {   // x, dy and dt of head h0 + n
    const size_t xh = ((size_t)b * p.S + t0) * row + (size_t)(h0 + n) * p.hd;
    stage<T, LDS, QM>(xs(n), X + xh, row, p.Q, p.hd);
    stage<T, LDS, QM>(dys(n), DY + xh, row, p.Q, p.hd);
    float* d = dts(n);
    for (int i = tid; i < QM; i += NT)
      cp_async4(d + i, i < p.Q ? p.dt + ((size_t)b * p.S + t0 + i) * p.nh
                                         + h0 + n : p.dt, i < p.Q ? 4 : 0);
  };
  auto load_states = [&](int n) {   // dH_c and h_{c-1} of head h0 + n
    const size_t at = (((size_t)b * p.nh + h0 + n) * p.nc + c) * p.hd * p.ds;
    stage<float, HLD, HM>(dHs, p.dstate + at, p.ds, p.hd, p.ds);
    stage<float, HLD, HM>(hs, p.states + at, p.ds, p.hd, p.ds);
  };
  stage<T, LDS, QM>(Bs, static_cast<const T*>(p.B) + bc0, p.bc_tstride,
                    p.Q, p.ds);
  stage<T, LDS, QM>(Cs, static_cast<const T*>(p.C) + bc0, p.bc_tstride,
                    p.Q, p.ds);
  load_head(0);
  cp_commit();
  load_states(0);
  cp_commit();
  if (tid < hn) {
    scal[1 + tid] = -expf(p.A_log[h0 + tid]);
    scal[1 + GMAX + tid] = p.D[h0 + tid];
  }

  // dB and dC of the group, summed over its heads: this warp's units are
  // the 16-row blocks ub[0] = a and ub[1] = NRB - 1 - a (a = warp % 4,
  // 9 pair tiles between them), columns n0 = 32 (warp / 4)..
  const int half = warp / (NRB / 2), n0 = 32 * half;
  const int ub[2] = {warp % (NRB / 2), NRB - 1 - warp % (NRB / 2)};
  float dBacc[2][4][4] = {}, dCacc[2][4][4] = {};
#pragma unroll 1
  for (int n = 0; n < hn; ++n) {
    const int h = h0 + n;
    if (STG == 2 && n + 1 < hn) {
      load_head(n + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Xs = xs(n);
    const T* Ys = dys(n);
    const float* dt = dts(n);
    const float A = scal[1 + n];

    // a. warp 0: cum; the others: <dH_c, h_{c-1}> and sum x . dy (dD's
    // part; a product of bf16 values is exact in fp32) over the chunk,
    // in double
    if (warp == 0) {
      head_cum(dt, A, chi, clo, eQ, ecum, scal);
      if (lane == 0) red[0] = red[8] = 0.0;
    } else {
      double pe = 0.0, pd = 0.0;
      for (int k = tid - 32; k < HM * DM; k += NT - 32) {
        const int at = (k / DM) * HLD + k % DM;
        pe += (double)dHs[at] * hs[at];
      }
      for (int k = tid - 32; k < QM * HM; k += NT - 32) {
        const int at = (k / HM) * LDS + k % HM;
        if (K == 1) pd += (double)(load(Xs, at) * load(Ys, at));
        else pd += (double)load(Xs, at) * load(Ys, at);
      }
      pe = warp_sum(pe);
      pd = warp_sum(pd);
      if (lane == 0) {
        red[warp] = pe;
        red[8 + warp] = pd;
      }
    }
    __syncthreads();
    // b. every pair tile once: M = x dy^T and C B^T, f = e^{cum_m - cum_r}
    // (m >= r), P = f dt_r M and (bf16) R = f C B^T kept for d; T^T = P .
    // C B^T (m > r) and its sums
    for (int k = warp; k < NTILE; k += NT / 32) {
      int rb, mb;
      tile_rc(k, rb, mb);
      float acc[2][4] = {}, cb[2][4] = {}, rv[2][4];
      pair<T, LDS>(acc, Xs, Ys, rb, mb, hsteps);
      pair<T, LDS>(cb, Bs, Cs, rb, mb, dsteps);
      double tv[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rb * 16 + g + (e >> 1) * 8;
          const int m = mb * 16 + nn * 8 + 2 * t + (e & 1);
          const float f = m >= i ? decay(chi, clo, m, i) : 0.0f;
          rv[nn][e] = cb[nn][e] * f;
          acc[nn][e] *= f * dt[i];
          tv[nn][e] = m > i ? (double)(acc[nn][e] * cb[nn][e]) : 0.0;
        }
      put_frag(Ps, k, acc);
      if (K == 1) put_frag(Rs, k, rv);
      if (rb == mb) {
        // the tile's part of da_t: T^T[r][m] over r < t <= m, 16 bins
        double v[16] = {};
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e >> 1) * 8, m = nn * 8 + 2 * t + (e & 1);
#pragma unroll
            for (int s = 0; s < 16; ++s)
              if (r < s && s <= m) v[s] += tv[nn][e];
          }
        const double sum = warp_reduce_scatter(v);
        if ((lane & 1) == 0) box[rb * 16 + (lane >> 1)] = sum;
      } else {
        // its row sums, column sums and total
        double r0 = (tv[0][0] + tv[0][1]) + (tv[1][0] + tv[1][1]);
        double r1 = (tv[0][2] + tv[0][3]) + (tv[1][2] + tv[1][3]);
        double cs[2][2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int q = 0; q < 2; ++q) cs[nn][q] = tv[nn][q] + tv[nn][2 + q];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          r0 += __shfl_xor_sync(0xffffffffu, r0, off);
          r1 += __shfl_xor_sync(0xffffffffu, r1, off);
        }
        double full = r0 + r1;
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1) {
          full += __shfl_xor_sync(0xffffffffu, full, off);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              cs[nn][q] += __shfl_xor_sync(0xffffffffu, cs[nn][q], off);
        }
        const int o = k - NRB;
        if (t == 0) {
          rowT[o * 16 + g] = (float)r0;
          rowT[o * 16 + g + 8] = (float)r1;
        }
        if (g == 0)
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              colT[o * 16 + nn * 8 + 2 * t + q] = (float)cs[nn][q];
        if (lane == 0) Sfull[o] = full;
      }
    }
    __syncthreads();

    // c. da's pair sums, sum_{r < t <= m} T^T[r][m], from the tile sums:
    // the diagonal tile's bins, the prefix over r < t of the row sums of
    // the tiles right of it, the suffix over m >= t of the column sums of
    // the tiles above it, and the tiles wholly on both sides of t
    if (tid < QM) {
      const int tb = tid >> 4, tau = tid & 15;
      double rs = 0.0, cs = 0.0, F = 0.0;
      for (int ib = tb + 1; ib < NRB; ++ib)
        rs += rowT[(tile_id(tb, ib) - NRB) * 16 + tau];
      for (int jb = 0; jb < tb; ++jb)
        cs += colT[(tile_id(jb, tb) - NRB) * 16 + tau];
      for (int jb = 0; jb < tb; ++jb)
        for (int ib = tb + 1; ib < NRB; ++ib)
          F += Sfull[tile_id(jb, ib) - NRB];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, rs, off, 16);
        const double down = __shfl_down_sync(0xffffffffu, cs, off, 16);
        if (tau >= off) rs += up;
        if (tau + off < 16) cs += down;
      }
      rs = __shfl_up_sync(0xffffffffu, rs, 1, 16);
      if (tau == 0) rs = 0.0;
      dain[tid] = ((box[tid] + rs) + cs) + F;
    }

    // d. the products: dx and dB by rows (R = C B^T f' with f' =
    // e^{cum_m - cum_r}, m >= r, times dy; P times C), dC by columns
    // (P^T, transposed in registers, times B); then each one's U H term,
    // whose dH_c or h_{c-1} fragments the warp's two units share
    const float Dh = scal[1 + GMAX + n];
    const size_t xh = ((size_t)b * p.S + t0) * row + (size_t)h * p.hd;
    {
      float xi[2][4][4] = {}, xe[2][4][4] = {};
      if (n0 < p.hd || n0 < p.ds)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rb = ub[u];
          for (int mb = rb; mb < NRB; ++mb) {
            const int k = tile_id(rb, mb);
            float rv[2][4] = {}, pv[2][4];
            if (K == 1) {
              get_frag(Rs, k, rv);
            } else {
              pair<T, LDS>(rv, Bs, Cs, rb, mb, dsteps);
#pragma unroll
              for (int nn = 0; nn < 2; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int i = rb * 16 + g + (e >> 1) * 8;
                  const int m = mb * 16 + nn * 8 + 2 * t + (e & 1);
                  rv[nn][e] *= m >= i ? decay(chi, clo, m, i) : 0.0f;
                }
            }
            get_frag(Ps, k, pv);
            uint32_t aR[3][4], aP[3][4], b0[K][4], b1[K][4];
            split_a(rv, aR);
            split_a(pv, aP);
            if (n0 < p.hd) {
              frag_b<T, LDS>(b0, Ys, mb * 16, n0);
              frag_b<T, LDS>(b1, Ys, mb * 16, n0 + 16);
              float st[4][4] = {};
              mma32<3, K>(st, aR, b0, b1);
              add_to(xi[u], st);
            }
            if (n0 < p.ds) {
              frag_b<T, LDS>(b0, Cs, mb * 16, n0);
              frag_b<T, LDS>(b1, Cs, mb * 16, n0 + 16);
              float st[4][4] = {};
              mma32<3, K>(st, aP, b0, b1);
              add_to(dBacc[u], st);
            }
          }
        }
      // B dH^T, dH_c in 3 terms
      if (n0 < p.hd)
        for (int ks = 0; ks < dsteps; ++ks) {
          uint32_t h0b[3][4], h1b[3][4];
          frag_bt<float, HLD>(h0b, dHs, n0, ks * 16);
          frag_bt<float, HLD>(h1b, dHs, n0 + 16, ks * 16);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[K][4];
            frag_a<T, LDS>(a, Bs, ub[u] * 16, ks * 16);
            float st[4][4] = {};
            mma32<K, 3>(st, a, h0b, h1b);
            add_to(xe[u], st);
          }
        }
      // dx, and the row sums x . dx' (in-chunk part and U H part) over
      // this warp's 32 columns
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rb = ub[u];
        float r0[2] = {0.0f, 0.0f}, r1[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = rb * 16 + g + (e >> 1) * 8;
            const int col = n0 + nn * 8 + 2 * t + (e & 1);
            if (i >= p.Q || col >= p.hd) continue;
            const float intra = xi[u][nn][e], inter = eQ[i] * xe[u][nn][e];
            const float z = load(Ys, i * LDS + col);
            store(static_cast<T*>(p.dx), xh + (size_t)i * row + col,
                  dt[i] * (intra + inter) + Dh * z);
            const float xv = load(Xs, i * LDS + col);
            r0[e >> 1] += xv * intra;
            r1[e >> 1] += xv * inter;
          }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            r0[q] += __shfl_xor_sync(0xffffffffu, r0[q], off);
            r1[q] += __shfl_xor_sync(0xffffffffu, r1[q], off);
          }
        if (t == 0)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            part[(half * 3 + 0) * QM + rb * 16 + g + q * 8] = r0[q];
            part[(half * 3 + 1) * QM + rb * 16 + g + q * 8] = r1[q];
          }
      }
    }
    {
      // x dH_c, dB's U H term
      float be[2][4][4] = {};
      if (n0 < p.ds)
        for (int ks = 0; ks < hsteps; ++ks) {
          uint32_t h0b[3][4], h1b[3][4];
          frag_b<float, HLD>(h0b, dHs, ks * 16, n0);
          frag_b<float, HLD>(h1b, dHs, ks * 16, n0 + 16);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[K][4];
            frag_a<T, LDS>(a, Xs, ub[u] * 16, ks * 16);
            float st[4][4] = {};
            mma32<K, 3>(st, a, h0b, h1b);
            add_to(be[u], st);
          }
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ub[u] * 16 + g + (e >> 1) * 8;
            dBacc[u][nn][e] += (dt[i] * eQ[i]) * be[u][nn][e];
          }
    }
    {
      float ce[2][4][4] = {};
      if (n0 < p.ds) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kb = ub[u];
          for (int mb = 0; mb <= kb; ++mb) {
            float pv[2][4];
            get_frag(Ps, tile_id(mb, kb), pv);
            uint32_t aP[3][4], aT[3][4], b0[K][4], b1[K][4];
            split_a(pv, aP);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              aT[j][0] = movT(aP[j][0]);
              aT[j][1] = movT(aP[j][2]);
              aT[j][2] = movT(aP[j][1]);
              aT[j][3] = movT(aP[j][3]);
            }
            frag_b<T, LDS>(b0, Bs, mb * 16, n0);
            frag_b<T, LDS>(b1, Bs, mb * 16, n0 + 16);
            float st[4][4] = {};
            mma32<3, K>(st, aT, b0, b1);
            add_to(dCacc[u], st);
          }
        }
        // dy h_{c-1}, h_{c-1} in 3 terms
        for (int ks = 0; ks < hsteps; ++ks) {
          uint32_t h0b[3][4], h1b[3][4];
          frag_b<float, HLD>(h0b, hs, ks * 16, n0);
          frag_b<float, HLD>(h1b, hs, ks * 16, n0 + 16);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[K][4];
            frag_a<T, LDS>(a, Ys, ub[u] * 16, ks * 16);
            float st[4][4] = {};
            mma32<K, 3>(st, a, h0b, h1b);
            add_to(ce[u], st);
          }
        }
      }
      // dC's U H term e^{cum_k} dy_k h_{c-1} and its row sums C . dC_h
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kb = ub[u];
        float r4[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kb * 16 + g + (e >> 1) * 8;
            const int col = n0 + nn * 8 + 2 * t + (e & 1);
            const float inter = ecum[i] * ce[u][nn][e];
            dCacc[u][nn][e] += inter;
            if (i < p.Q && col < p.ds)
              r4[e >> 1] += load(Cs, i * LDS + col) * inter;
          }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1)
            r4[q] += __shfl_xor_sync(0xffffffffu, r4[q], off);
        if (t == 0)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            part[(half * 3 + 2) * QM + kb * 16 + g + q * 8] = r4[q];
      }
    }
    __syncthreads();
    // the next head's dH_c and h_{c-1} (and, with one stage, x, dy, dt)
    // load while this one's da is finished
    if (n + 1 < hn) {
      if (STG == 1) load_head(n + 1);
      load_states(n + 1);
      cp_commit();
    }

    // e. da_t = pair sums + sum_{i >= t} C . dC_h + sum_{j < t} dt x .
    // dx_h + e^{cum_Q} <dH_c, h_{c-1}>, in double (the suffix and prefix
    // sums as warp scans over 4 warps, the other warps' totals added in a
    // fixed order); then ddt, and the chunk's parts of dA_log and dD
    if (tid < QM) {
      const float s0 = part[tid] + part[3 * QM + tid];
      const float s1 = part[QM + tid] + part[4 * QM + tid];
      double su = (double)(part[2 * QM + tid] + part[5 * QM + tid]);
      double pr = (double)dt[tid] * s1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, pr, off);
        const double down = __shfl_down_sync(0xffffffffu, su, off);
        if (lane >= off) pr += up;
        if (lane + off < 32) su += down;
      }
      if (lane == 31) red[16 + warp] = pr;
      if (lane == 0) red[20 + warp] = su;
      bar_step();
      for (int w = 0; w < warp; ++w) pr += red[16 + w];
      for (int w = QM / 32 - 1; w > warp; --w) su += red[20 + w];
      double E = 0.0;
      for (int w = 0; w < NT / 32; ++w) E += red[w];
      E *= (double)scal[0];
      double dtda = 0.0;
      if (tid < p.Q) {
        const double da = dain[tid] + su + (pr - (double)dt[tid] * s1) + E;
        p.ddt[((size_t)b * p.S + t0 + tid) * p.nh + h] =
            (float)((double)(s0 + s1) + (double)A * da);
        dtda = (double)dt[tid] * da;
      }
      dtda = warp_sum(dtda);
      if (lane == 0) red[24 + warp] = dtda;
      bar_step();
      if (tid == 0) {
        double sa = 0.0, sd = 0.0;
        for (int w = 0; w < QM / 32; ++w) sa += red[24 + w];
        for (int w = 0; w < NT / 32; ++w) sd += red[8 + w];
        p.dApart[((size_t)b * p.nc + c) * p.nh + h] = (float)sa;
        p.dDpart[((size_t)b * p.nc + c) * p.nh + h] = (float)sd;
      }
    }
  }

  // f. the group's dB and dC parts
  const size_t part0 = ((size_t)b * p.ng + grp) * p.S + t0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ub[u] * 16 + g + (e >> 1) * 8;
        const int col = n0 + nn * 8 + 2 * t + (e & 1);
        if (i >= p.Q || col >= p.ds) continue;
        const size_t at = (part0 + i) * p.ds + col;
        p.dBpart[at] = dBacc[u][nn][e];
        p.dCpart[at] = dCacc[u][nn][e];
      }
  }
}

// 4. dB and dC as the groups' parts summed in a fixed order, in double, a
// thread an element of (Bb, S, ds); and dA_log = A sum dt da and dD over
// (batch, chunk), a thread a head.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_sum(Params p) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t sd = (size_t)p.S * p.ds, n = (size_t)p.Bb * sd;
  if (e < n) {
    const size_t b = e / sd, rem = e % sd;
    double sb = 0.0, sc = 0.0;
    for (int q = 0; q < p.ng; ++q) {
      const size_t off = ((size_t)b * p.ng + q) * sd + rem;
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

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int K = terms<T>();
  cudaError_t e = launch_opt_in<ssd_scan_bwd_state<T>>(
      dim3(p.nc, p.nh, p.Bb), NT, state_smem(K), state_smem(K), p, stream);
  if (e != cudaSuccess) return e;
  ssd_scan_bwd_pass<<<dim3((p.hd * p.ds + 4 * NT - 1) / (4 * NT),
                           p.Bb * p.nh), NT, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_opt_in<ssd_scan_bwd_chunk<T>>(
      dim3(p.nc, p.ng, p.Bb), NT, Smem<T>::TOTAL, Smem<T>::TOTAL, p, stream);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)p.Bb * p.S * p.ds;
  const size_t m = n > (size_t)p.nh ? n : (size_t)p.nh;
  ssd_scan_bwd_sum<T><<<(unsigned)((m + NT - 1) / NT), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, dy, B, C, dx, dB, dC): 0 = float32, 1 = bfloat16. dhT may
// be null. G: heads a chunk block, 1..8. dstate, decay, dBpart, dCpart,
// dApart and dDpart are the wrapper's fp32 scratch of (Bb, nh, S / Q, hd,
// ds), (Bb, nh, S / Q), (Bb, ceil(nh / G), S, ds) twice and (Bb, S / Q,
// nh) twice floats. Returns the first CUDA error of the four launches (0
// on success); the wrapper raises on anything else. The wrapper has
// checked Q <= 128, hd <= 64, ds <= 64, S % Q == 0.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* states, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dA_log, void* dB, void* dC,
    void* dD, void* dstate, void* decay, void* dBpart, void* dCpart,
    void* dApart, void* dDpart, int dtype, int Bb, int S, int nh, int hd,
    int ds, int Q, int G, long long bc_bstride, long long bc_tstride,
    void* stream) {
  if (Q < 1 || Q > QM || hd < 1 || hd > HM || ds < 1 || ds > DM ||
      S % Q != 0 || G < 1 || G > GMAX)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt),
           static_cast<const float*>(A_log), B, C,
           static_cast<const float*>(D), static_cast<const float*>(states),
           dy, static_cast<const float*>(dhT), dx,
           static_cast<float*>(ddt), static_cast<float*>(dA_log), dB, dC,
           static_cast<float*>(dD), static_cast<float*>(dstate),
           static_cast<float*>(decay), static_cast<float*>(dBpart),
           static_cast<float*>(dCpart), static_cast<float*>(dApart),
           static_cast<float*>(dDpart), Bb, S, nh, hd, ds, Q, S / Q, G,
           (nh + G - 1) / G, bc_bstride, bc_tstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
