// Forward flash attention (online softmax) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (`_kernel`, pallas_call in
// `flash_attention`). Same function, same contract as its oracle
// `ref.py::flash_attention_ref`:
//   q (B, H, Sq, hd), k/v (B, KV, Sk, hd), contiguous, fp32 or bf16;
//   o (B, H, Sq, hd) of q's dtype. GQA by index: KV head = h / (H / KV),
//   never materialised. scale = hd**-0.5; scores in fp32; optional tanh
//   softcap; masks k_pos < Sk, causal k_pos <= q_pos, window
//   q_pos - k_pos < window, with q_pos = i + (Sk - Sq); masked scores are
//   the finite -2**30. Running m, l and acc in fp32; p is rounded to v's
//   dtype before the PV product while l sums the unrounded p; the output
//   is acc / max(l, 1e-30). A row with no unmasked key (only possible for
//   Sq > Sk under the causal mask) is outside the contract, as it is for
//   the TPU kernel.
//
// What bounds it. The serving slice calls it at (B, H, KV, Sq, Sk, hd) =
// (4, 32, 8, 2048, 2048, 128), bf16, causal: 4 * B * H * hd * (unmasked
// (q, k) pairs) = 4 * 4 * 32 * 128 * 2098176 = 1.375e14 FLOP, 0.139 ms at
// the H100's 989 TFLOP/s bf16 dense peak, against 167.8 MB of q, k, v and
// o moved once, 0.050 ms at 3.35 TB/s. It is bound by operations.
//
// What the design does about that. The TPU kernel's sequential kv grid
// axis with (m, l, acc) in VMEM scratch becomes a loop over kv tiles
// inside one block; a block owns BQ query rows of one (b, h), so nothing
// crosses blocks. Grid (B * H, ceil(Sq / BQ)), launched with the longest
// causal rows first. K and V tiles are staged in shared memory; kv tiles
// wholly masked for the block (beyond the causal horizon, before the
// window) are never loaded; ragged Sq and Sk are masked in the kernel
// (out-of-range keys load as zeros), with no padding copies.
//  - bf16: both products run on the tensor cores with mma.sync
//    m16n8k16 (bf16 in, fp32 accumulate). Each of 4 warps owns 16 query
//    rows: its q fragments, the (16, BK) score tile, the (16, hd) output
//    accumulator and the row statistics stay in registers, and the score
//    accumulator is re-packed in registers as the A operand of the PV
//    product (the rounding of p to bf16). BQ = BK = 64. K and V tiles
//    (16 KB each at hd = 128, + 8 bf16 of padding a row against bank
//    conflicts) are double-buffered with cp.async, so the next tile loads
//    while this one is computed, and reach the tensor cores through
//    ldmatrix (.trans for V). Scores are kept in log2 units so that
//    exp is one ex2.approx, and tiles wholly visible to every row of the
//    block skip the mask arithmetic.
//  - fp32: no tensor-core path keeps full fp32 (TF32 keeps ten mantissa
//    bits), so the products are plain fp32 FMA: four threads share a
//    query row, each holding a quarter of q and acc in registers, and
//    the partial dot products meet by warp shuffles. BQ = 64, BK = 32.
// wgmma, TMA and warp specialisation are left to a later change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, finite as in the oracle

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  int causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float score(float dot, const Params& p, int kpos,
                                       int qpos) {
  float s = dot * p.scale;
  if (p.softcap != 0.0f) s = tanhf(s / p.softcap) * p.softcap;
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
  return ok ? s : kNegInf;
}

// Key range [kbeg, kend) a block of query rows [q0, q0 + nq) must visit:
// tiles wholly past the causal horizon or before the window are skipped.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int nq,
                                         int bk, int& kbeg, int& kend) {
  const int off = p.Sk - p.Sq;
  kend = p.Sk;
  if (p.causal) kend = min(kend, q0 + nq - 1 + off + 1);
  kbeg = 0;
  if (p.window > 0) kbeg = max(0, q0 + off - p.window + 1);
  kbeg = (kbeg / bk) * bk;
}

// ---------------------------------------------------------------- fp32 ---

template <int HD>
__global__ void __launch_bounds__(256)
flash_fwd_f32(Params p) {
  constexpr int BQ = 64, BK = 32, TPR = 4, NC = HD / TPR;
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // long rows first
  const int nq = min(BQ, p.Sq - q0);
  const int tid = threadIdx.x, r = tid / TPR, part = tid % TPR;
  const int qi = q0 + r;
  const int qpos = qi + p.Sk - p.Sq;
  const float* Q = static_cast<const float*>(p.q) + (size_t)bh * p.Sq * HD;
  const size_t kv_off = (size_t)(b * p.KV + kvh) * p.Sk * HD;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;

  // thread `part` of a row owns columns part, part + 4, part + 8, ...
  float q[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    q[i] = qi < p.Sq ? Q[(size_t)qi * HD + i * TPR + part] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;
  int kbeg, kend;
  kv_range(p, q0, nq, BK, kbeg, kend);

  for (int kt = kbeg; kt < kend; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD / 4; idx += blockDim.x) {
      const int row = idx / (HD / 4), c4 = idx % (HD / 4);
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kt + row < p.Sk) {
        kk = reinterpret_cast<const float4*>(K + (size_t)(kt + row) * HD)[c4];
        vv = reinterpret_cast<const float4*>(V + (size_t)(kt + row) * HD)[c4];
      }
      reinterpret_cast<float4*>(&Ks[row][0])[c4] = kk;
      reinterpret_cast<float4*>(&Vs[row][0])[c4] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) d = fmaf(q[i], Ks[j][i * TPR + part], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = score(d, p, kt + j, qpos);
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    float ls = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mt);
      ls += s[j];
    }
    l = l * alpha + ls;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a = fmaf(s[j], Vs[j][i * TPR + part], a);
      acc[i] = a;
    }
    m = mt;
  }
  if (qi < p.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* O = static_cast<float*>(p.o) + (size_t)bh * p.Sq * HD
        + (size_t)qi * HD;
#pragma unroll
    for (int i = 0; i < NC; ++i) O[i * TPR + part] = acc[i] / den;
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices from shared memory; lanes 8 m .. 8 m + 7 give
// the row addresses of matrix m, and lane 4 g + t receives row g, columns
// 2t and 2t + 1 of each (of its transpose with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 16 bytes global -> shared without staging in registers; `bytes` = 0
// fills the 16 bytes with zeros (a key past Sk)
__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(g), "r"(bytes));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&v);
}

// mma.sync m16n8k16 fragments (PTX ISA), lane = 4 g + t:
//   A (16 x 16): {row g, cols 2t..2t+1}, {row g+8, same}, {row g, cols
//                2t+8..2t+9}, {row g+8, same}
//   B (16 x 8):  {rows 2t..2t+1, col g}, {rows 2t+8..2t+9, col g}
//   C (16 x 8):  row g cols 2t, 2t+1; row g+8 cols 2t, 2t+1
// Scores are kept in log2 units (s * log2 e) so that p = 2^(s - m) is one
// ex2 instruction; a masked score is -2**30 * log2 e, which keeps the
// oracle's behaviour for rows whose keys are all masked so far.
template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(Params p) {
  constexpr int BQ = 64, BK = 64, LD = HD + 8, TILE = BK * LD;
  constexpr int KSTEPS = HD / 16, NS = BK / 8, NO = HD / 8;
  // two stages of (K tile, V tile), (BK, LD) each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // long rows first
  const int nq = min(BQ, p.Sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int off = p.Sk - p.Sq;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q)
      + (size_t)bh * p.Sq * HD;
  const size_t kv_off = (size_t)(b * p.KV + kvh) * p.Sk * HD;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  const float neg2 = kNegInf * kLog2e;

  auto load_tile = [&](int stage, int kt) {
    __nv_bfloat16* Ks = smem + stage * 2 * TILE;
    for (int idx = tid; idx < BK * HD / 8; idx += blockDim.x) {
      const int row = idx / (HD / 8), c8 = idx % (HD / 8);
      const bool in = kt + row < p.Sk;
      const size_t g_off = (size_t)(in ? kt + row : 0) * HD + c8 * 8;
      const uint32_t s_k = (uint32_t)__cvta_generic_to_shared(
          Ks + row * LD + c8 * 8);
      cp_async16(s_k, K + g_off, in ? 16 : 0);
      cp_async16(s_k + TILE * 2, V + g_off, in ? 16 : 0);
    }
  };

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e & 1], col = kk * 16 + 2 * t + (e >> 1) * 8;
      qa[kk][e] = row < p.Sq
          ? *reinterpret_cast<const uint32_t*>(Q + (size_t)row * HD + col)
          : 0u;
    }
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {neg2, neg2}, l[2] = {0.0f, 0.0f};
  int kbeg, kend;
  kv_range(p, q0, nq, BK, kbeg, kend);
  // per-lane ldmatrix offsets (elements) inside a tile: K rows for the
  // score product, V rows (transposed) for the PV product
  const int k_lane = (lane & 7) * LD + (lane >> 3) * 8;
  const int v_lane = ((lane >> 3 & 1) * 8 + (lane & 7)) * LD
      + (lane >> 4) * 8;

  if (kbeg < kend) load_tile(0, kbeg);
  asm volatile("cp.async.commit_group;\n" ::);
  int stage = 0;
  for (int kt = kbeg; kt < kend; kt += BK, stage ^= 1) {
    if (kt + BK < kend) load_tile(stage ^ 1, kt + BK);   // next tile in flight
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const __nv_bfloat16* Ks = smem + stage * 2 * TILE;
    const uint32_t k_base = (uint32_t)__cvta_generic_to_shared(Ks + k_lane);
    const uint32_t v_base =
        (uint32_t)__cvta_generic_to_shared(Ks + TILE + v_lane);

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, k_base + 2 * (j * 8 * LD + kk * 16));
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j], qa[kk + 1], kb[2], kb[3]);
      }
    }
    // a tile needs no mask when every key is visible to every row
    const bool full = kt + BK <= p.Sk
        && (!p.causal || kt + BK - 1 <= q0 + off)
        && (p.window == 0 || q0 + nq - 1 + off - kt < p.window);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (full && p.softcap == 0.0f) {
          x = s[j][e] * (p.scale * kLog2e);
        } else {
          const int key = kt + j * 8 + 2 * t + (e & 1);
          x = score(s[j][e], p, key, rows[e >> 1] + off) * kLog2e;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // the row's max over its quad of lanes
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      alpha[i] = ex2(m[i] - mt[i]);
      l[i] *= alpha[i];             // l: this lane's share of the row sum
      m[i] = mt[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - mt[e >> 1]);
        l[e >> 1] += s[j][e];       // the unrounded p
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: the score accumulator re-packed as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, v_base + 2 * (kk * 16 * LD + n * 8));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is refilled two iterations on
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.Sq * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(O + (size_t)rows[i] * HD + n * 8 + 2 * t) =
          pack_f32(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  dim3 grid(p.B * p.H, (p.Sq + 63) / 64);
  if constexpr (sizeof(T) == 4) {
    flash_fwd_f32<HD><<<grid, 256, 0, stream>>>(p);
  } else {
    constexpr int smem = 4 * 64 * (HD + 8) * 2;   // 2 stages x (K, V)
    return launch_opt_in<flash_fwd_bf16<HD>>(grid, 128, smem, smem, p,
                                             stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch
// (0 on success); the wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int KV, int Sq, int Sk,
                                      int hd, int causal, int window,
                                      float scale, float softcap,
                                      void* stream) {
  Params p{q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(p, hd, s);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(p, hd, s);
  return (int)cudaErrorInvalidValue;
}
