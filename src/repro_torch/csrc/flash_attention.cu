// Forward flash attention (online softmax) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (`_kernel`, pallas_call in
// `flash_attention`). Same function, same contract as its oracle
// `ref.py::flash_attention_ref`:
//   q (B, H, Sq, hd), k/v (B, KV, Sk, hd), fp32 or bf16, each with any
//   strides whose head-dim stride is 1 and whose other strides are
//   multiples of 16 bytes (the model layout (B, S, heads, hd) swapped to
//   this order is read in place); o the same, with its own strides. GQA
//   by index: KV head = h / (H / KV), never materialised. scale =
//   hd**-0.5; scores in fp32; optional tanh softcap; masks k_pos < Sk,
//   causal k_pos <= q_pos, window q_pos - k_pos < window, with q_pos = i
//   + (Sk - Sq); masked scores are the finite -2**30. Running m, l and acc
//   in fp32; p is rounded to v's dtype before the PV product while l sums
//   the unrounded p; the output is acc / max(l, 1e-30). A row with no
//   unmasked key (only possible for Sq > Sk under the causal mask) is
//   outside the contract, as it is for the TPU kernel.
//
// What bounds it. The serving slice calls it at (B, H, KV, Sq, Sk, hd) =
// (4, 32, 8, 2048, 2048, 128), bf16, causal: 4 * B * H * hd * (unmasked
// (q, k) pairs) = 4 * 4 * 32 * 128 * 2098176 = 1.375e14 FLOP, 0.139 ms at
// the H100's 989 TFLOP/s bf16 dense peak, against 167.8 MB of q, k, v and
// o moved once, 0.050 ms at 3.35 TB/s. It is bound by operations, so the
// bf16 design is built around wgmma, the only way to the full rate.
//
// What the design does about that. The TPU kernel's sequential kv grid
// axis with (m, l, acc) in VMEM scratch becomes a loop over kv tiles
// inside one work item: BQ query rows of one (b, h), so nothing crosses
// blocks; kv tiles wholly masked for the item (beyond the causal horizon,
// before the window) are never loaded.
//  - bf16, hd 32, 64, 112, 128: persistent and warp-specialised. One
//    block of 384 threads an SM takes items from a counter (zeroed by
//    a memset before the launch), longest causal rows first.
//    Warpgroups 0 and 1 compute 64 query rows each; warpgroup 2 is
//    the producer, whose one thread issues TMA loads of each item's Q
//    (into one of QB buffers) and of its K and V tiles into a ring of ST
//    stages with full and empty mbarriers, so the next item's loads
//    overlap this item's last products and stores; setmaxnreg moves
//    registers from the producer (24) to the consumers (240). BQ = BK =
//    128. The TMA maps are 4-d over (hd, S, heads, B) with the caller's
//    strides, so the model layout is read in place and ragged Sq and Sk
//    rows (and the columns of hd 32 and 112 beyond hd) arrive as zeros; a
//    row of a tile is 64 bf16 in 128-byte swizzled shared memory, hd in
//    64-column blocks (hd 32 and 112 padded to 64 and 128 with zeros).
//    S = Q K^T is one wgmma m64n128k16 per 16 of hd from shared memory
//    (K-major Q and K); p is rounded to bf16 in registers and O += P V is
//    wgmma with the register A operand and V read MN-major straight from
//    its tile (no transpose copy). S of tile i is issued together with
//    P V of tile i - 1, and the softmax of tile i runs while P V is in
//    flight; the two consumer warpgroups take turns at the tensor cores
//    (named barriers), so one's softmax overlaps the other's products.
//    Scores are kept in log2 units so that p is one ex2; the mask is
//    applied only to tiles that cross the diagonal, the window or a
//    ragged edge, with one branch around the whole tile. O is written
//    from registers to the caller's strides.
//  - fp32: no tensor-core path keeps full fp32 (TF32 keeps ten mantissa
//    bits), so the products are plain fp32 FMA: four threads share a
//    query row, each holding a quarter of q and acc in registers, and
//    the partial dot products meet by warp shuffles. BQ = 64, BK = 32.
// The tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// the library needs no link against libcuda.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, finite as in the oracle
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk, hd;
  // strides in elements of (b, head, s); the head-dim stride is 1
  long long qs[3], ks[3], vs[3], os[3];
  int* next;   // the bf16 kernel's work-item counter, zeroed at launch
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

__device__ __forceinline__ size_t at(const long long (&s)[3], int b, int h,
                                     int row) {
  return (size_t)(b * s[0] + h * s[1] + row * s[2]);
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
  const float* Q = static_cast<const float*>(p.q) + at(p.qs, b, h, 0);
  const float* K = static_cast<const float*>(p.k) + at(p.ks, b, kvh, 0);
  const float* V = static_cast<const float*>(p.v) + at(p.vs, b, kvh, 0);

  // thread `part` of a row owns columns part, part + 4, part + 8, ...
  float q[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    q[i] = qi < p.Sq ? Q[(size_t)qi * p.qs[2] + i * TPR + part] : 0.0f;
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
        kk = reinterpret_cast<const float4*>(
            K + (size_t)(kt + row) * p.ks[2])[c4];
        vv = reinterpret_cast<const float4*>(
            V + (size_t)(kt + row) * p.vs[2])[c4];
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
    float* O = static_cast<float*>(p.o) + at(p.os, b, h, qi);
#pragma unroll
    for (int i = 0; i < NC; ++i) O[i * TPR + part] = acc[i] / den;
  }
}

// ---------------------------------------------------------------- bf16 ---
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int BQ = 128, BK = 128;   // query rows an item, keys a kv tile
static_assert(BQ == BK, "issue_s steps through Q and K blocks alike");

// Shared memory of the bf16 kernel at padded head dim HDP (64 or 128),
// byte offsets from a 1024-aligned base: QB Q buffers (HDP / 64 blocks
// of BQ rows x 64 each), ST stages of K and of V (HDP / 64 blocks of BK
// rows x 64 each), then the mbarriers: Q full and empty (2 each), K/V
// full and empty (ST each), then the item index of each Q buffer. At hd
// 128 a third kv stage is worth more than a second Q buffer (measured);
// at hd <= 64 both fit.
template <int HDP>
struct Layout {
  static constexpr int QB = HDP == 128 ? 1 : 2;
  static constexpr int ST = HDP == 128 ? 3 : 4;
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;   // one tile of K or V
  static constexpr int K_OFF = QB * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int ITEM_OFF = BAR_OFF + 8 * (4 + 2 * ST);
  static constexpr int BYTES = ITEM_OFF + 8 + 1024;
};

// One work item: query rows [q0, q0 + BQ) of head h of batch b, over
// the kv tiles [kbeg, kbeg + ntiles BK). Items are numbered longest
// causal rows first.
struct Item {
  int b, h, kvh, q0, kbeg, ntiles;
  __device__ __forceinline__ Item(const Params& p, int item) {
    const int bh = item % (p.B * p.H), nqt = (p.Sq + BQ - 1) / BQ;
    b = bh / p.H;
    h = bh % p.H;
    kvh = h / (p.H / p.KV);
    q0 = (nqt - 1 - item / (p.B * p.H)) * BQ;
    int kend;
    kv_range(p, q0, min(BQ, p.Sq - q0), BK, kbeg, kend);
    ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  }
};

__device__ __forceinline__ void advance(int& stage, int& phase, int st) {
  if (++stage == st) {
    stage = 0;
    phase ^= 1;
  }
}

// Scores are kept in log2 units (s * log2 e) so that p = 2^(s - m) is one
// ex2 instruction; a masked score is -2**30 * log2 e, which keeps the
// oracle's behaviour for rows whose keys are all masked so far. The wgmma
// accumulator of a warp's 16 rows holds, for each 8 columns j, row g cols
// 8j + 2t, 8j + 2t + 1 in d[4j], d[4j + 1] and row g + 8 in d[4j + 2],
// d[4j + 3] (lane = 4 g + t): the mma.sync C layout, so 16 keys of p
// re-pack as the A fragment of the PV product in place. The kernel is
// persistent: a block per SM takes items from a counter, longest first,
// so that one item's loads overlap the previous item's last products and
// stores and the blocks end together.
template <int HDP>
__global__ void __launch_bounds__(384, 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const Params p) {
  using L = Layout<HDP>;
  constexpr int CH = HDP / 64;            // 64-column blocks of a row
  constexpr int NO = HDP / 2;             // O accumulator floats a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t qfull0 = base + L::BAR_OFF, qempty0 = qfull0 + 16;
  const uint32_t full0 = qfull0 + 32, empty0 = full0 + 8 * L::ST;
  int* qitem = reinterpret_cast<int*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::ITEM_OFF);
  const int items = p.B * p.H * ((p.Sq + BQ - 1) / BQ);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull0 + 8 * s, 1);
      mbar_init(qempty0 + 8 * s, 8);      // one arrival a consumer warp
    }
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {   // ------------------------------ producer warpgroup
    setmaxnreg_dec<24>();
    if (tid != 256) return;
    // Items are taken from a counter, longest first: the first one a
    // block is blockIdx.x, the next ones gridDim.x + the counter's count.
    // An item index < 0 in a Q buffer tells the consumers to stop.
    int stage = 0, phase = 0;
    for (int n = 0, item = blockIdx.x;; ++n) {
      const int qb = n % L::QB;
      mbar_wait(qempty0 + 8 * qb, ((n / L::QB) & 1) ^ 1);
      qitem[qb] = item < items ? item : -1;
      if (item >= items) {
        mbar_arrive(qfull0 + 8 * qb);
        return;
      }
      const Item w(p, item);
      mbar_expect_tx(qfull0 + 8 * qb, L::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load_4d(sQ + qb * L::Q_BYTES + c * BQ * 128, &tmQ,
                    qfull0 + 8 * qb, 64 * c, w.q0, w.h, w.b);
      item = gridDim.x + atomicAdd(p.next, 1);
      for (int it = 0; it < w.ntiles; ++it) {
        const int kt = w.kbeg + it * BK;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, 2 * L::KV_BYTES);
        for (int c = 0; c < CH; ++c) {
          const uint32_t o = stage * L::KV_BYTES + c * BK * 128;
          tma_load_4d(sK + o, &tmK, full, 64 * c, kt, w.kvh, w.b);
          tma_load_4d(sV + o, &tmV, full, 64 * c, kt, w.kvh, w.b);
        }
        advance(stage, phase, L::ST);
      }
    }
  }
  // ---------------------------------------------- consumer warpgroups 0, 1
  setmaxnreg_inc<240>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int off = p.Sk - p.Sq;
  const float neg2 = kNegInf * kLog2e;
  float o[NO], m[2] = {neg2, neg2}, l[2] = {0.0f, 0.0f}, alpha[2];
  int rows[2], r0;
  uint32_t qa;

  // S = Q K^T of the tile in `stage`: 64 rows x BK keys, K-major Q, K
  float s[BK / 2];   // written whole by the first product (scale 0)
  auto issue_s = [&](int stage) {
    const uint32_t kb = sK + stage * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t co = (kk / 4) * 128 * 128 + (kk % 4) * 32;
      wgmma_ss<0>(s, sw128_desc(qa + co, 16, 1024),
                  sw128_desc(kb + co, 16, 1024), kk > 0);
    }
  };
  // O += P V of the tile in `stage`: p (bf16) as the register A operand;
  // V MN-major (hd contiguous), 64-column blocks BK * 128 bytes apart
  uint32_t pa[BK / 16][4];
  auto issue_pv = [&](int stage) {
    const uint32_t vb = sV + stage * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], sw128_desc(vb + kk * 16 * 128, BK * 128, 1024),
                  1);
  };
  // The online softmax of the scores in s for keys [kt, kt + BK): s
  // becomes p, m and l move on, alpha rescales O.
  auto softmax = [&](int kt) {
    // a tile needs no mask when every key is visible to every row (one
    // branch around the whole tile: a branch per score costs the unmasked
    // tiles the masked path's instructions)
    const bool full = kt + BK <= p.Sk
        && (!p.causal || kt + BK - 1 <= r0 + off)
        && (p.window == 0 || r0 + 63 + off - kt < p.window);
    // Without softcap s keeps the raw dot products (a masked one set to
    // -2**30 / f) and f = scale * log2 e takes them to log2 units inside
    // p = 2^(s f - m), one FFMA and one ex2 a score (the max of the raw
    // scores, scaled, is the max of the scaled ones); the softcap path
    // scales s itself, f = 1.
    float mt[2] = {m[0], m[1]};
    float f = 1.0f;
    if (p.softcap == 0.0f) {
      f = p.scale * kLog2e;
      if (!full) {   // keys outside a row's [lo, hi) (columns counted from
                     // this lane's first key, kt + 2t) become -2**30 log2
        const float masked = neg2 / f;
        int lo[2], hi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qpos = rows[i] + off;
          hi[i] = min(p.Sk, p.causal ? qpos + 1 : p.Sk) - kt - 2 * t;
          lo[i] = p.window > 0 ? qpos - p.window + 1 - kt - 2 * t
                               : -(1 << 30);
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + (e & 1);
            if (c < lo[e >> 1] || c >= hi[e >> 1]) s[4 * j + e] = masked;
          }
        }
      }
      float mr[2][4];   // four partial maxima a row: short chains
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mr[0][c] = fmaxf(s[4 * c], s[4 * c + 1]);
        mr[1][c] = fmaxf(s[4 * c + 2], s[4 * c + 3]);
      }
#pragma unroll
      for (int j = 4; j < BK / 8; ++j) {
        mr[0][j % 4] = fmaxf(mr[0][j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
        mr[1][j % 4] = fmaxf(mr[1][j % 4],
                             fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mt[i] = fmaxf(mt[i], fmaxf(fmaxf(mr[i][0], mr[i][1]),
                                   fmaxf(mr[i][2], mr[i][3])) * f);
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + j * 8 + 2 * t + (e & 1);
          s[4 * j + e] = score(s[4 * j + e], p, key, rows[e >> 1] + off)
              * kLog2e;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * j + e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // the row's max over its quad
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      alpha[i] = ex2(m[i] - mt[i]);
      l[i] *= alpha[i];
      m[i] = mt[i];
    }
    float ls[2][4] = {};   // the unrounded p summed in four partial sums
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], f, -mt[e >> 1]));
        ls[e >> 1][j % 4] += s[4 * j + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)   // l: this lane's share of the row sum
      l[i] += (ls[i][0] + ls[i][1]) + (ls[i][2] + ls[i][3]);
  };
  auto pack_p = [&] {   // p rounded to bf16, the A fragments of P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  };
  // The two warpgroups take turns at the tensor cores (named barriers 1
  // and 2): while one issues its products the other runs its softmax.
  auto turn_begin = [&] {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg));
  };
  auto turn_end = [&] {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg));
  };
  if (wg == 1) asm volatile("bar.arrive 1, 256;\n");   // warpgroup 0 first

  int stage = 0, phase = 0;   // the next kv tile's stage and phase
  for (int n = 0;; ++n) {
    const int qb = n % L::QB;
    mbar_wait(qfull0 + 8 * qb, (n / L::QB) & 1);
    const int item = qitem[qb];
    if (item < 0) break;
    const Item w(p, item);
    r0 = w.q0 + wg * 64;                         // the warpgroup's rows
    rows[0] = r0 + wl * 16 + g;
    rows[1] = rows[0] + 8;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    m[0] = m[1] = neg2;
    l[0] = l[1] = 0.0f;
    qa = sQ + qb * L::Q_BYTES + wg * 64 * 128;

    // Tile it: S of tile it is issued with P V of tile it - 1, and the
    // softmax of tile it runs while P V is in flight. Tile 0 is peeled
    // off, so that no branch separates the products of a turn.
    int prev = stage;
    if (w.ntiles > 0) {
      mbar_wait(full0 + 8 * stage, phase);
      turn_begin();
      wgmma_fence();
      issue_s(stage);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      reg_fence(s);
      softmax(w.kbeg);   // O is still zero: nothing to rescale
      pack_p();
      prev = stage;
      advance(stage, phase, L::ST);
    }
    for (int it = 1; it < w.ntiles; ++it) {
      mbar_wait(full0 + 8 * stage, phase);
      turn_begin();
      wgmma_fence();
      issue_s(stage);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();
      reg_fence(s);
      softmax(w.kbeg + it * BK);
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      pack_p();
      prev = stage;
      advance(stage, phase, L::ST);
    }
    if (lane == 0) mbar_arrive(qempty0 + 8 * qb);   // Q read by every S
    if (w.ntiles > 0) {
      turn_begin();
      wgmma_fence();
      issue_pv(prev);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= p.Sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = O + at(p.os, w.b, w.h, rows[i]);
#pragma unroll
      for (int c = 0; c < NO / 4; ++c) {
        const int col = c * 8 + 2 * t;
        if (col < p.hd)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[4 * c + 2 * i] / den, o[4 * c + 2 * i + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------- host ---

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// 4-d map over (hd, S, heads, B) with strides s = (b, head, s) in
// elements; boxes of 64 columns x `rows` rows of one head, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
              int B, const long long (&s)[3], int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                           (cuuint64_t)s[0] * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.hd, p.Sq, p.H, p.B, p.qs, BQ) ||
      !make_map(&tk, p.k, p.hd, p.Sk, p.KV, p.B, p.ks, BK) ||
      !make_map(&tv, p.v, p.hd, p.Sk, p.KV, p.B, p.vs, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<HDP>::BYTES;
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_bf16_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return set;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int items = p.B * p.H * ((p.Sq + BQ - 1) / BQ);
  const cudaError_t z = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
  if (z != cudaSuccess) return z;
  flash_fwd_bf16_wgmma<HDP><<<min(items, sms), 384, smem, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid(p.B * p.H, (p.Sq + 63) / 64);
  flash_fwd_f32<HD><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd 32, 64, 112 or 128. Strides in
// elements, (b, head, s) for each of q, k, v and o; `next` is one int32
// of the wrapper's scratch (the bf16 kernel's item counter). Returns the
// CUDA error of the launches (0 on success); the wrapper raises on
// anything else.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, float scale,
    float softcap, void* next, void* stream) {
  Params p{q, k, v, o, B, H, KV, Sq, Sk, hd,
           {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           {osb, osh, oss}, static_cast<int*>(next), causal, window, scale,
           softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32: return (int)launch_f32<32>(p, s);
      case 64: return (int)launch_f32<64>(p, s);
      case 112: return (int)launch_f32<112>(p, s);
      case 128: return (int)launch_f32<128>(p, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: case 64: return (int)launch_bf16<64>(p, s);
      case 112: case 128: return (int)launch_bf16<128>(p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
