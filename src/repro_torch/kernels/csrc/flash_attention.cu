// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 exactly on the FMA units.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel). q (BH, Sq, hd), k/v (BKV, Sk, hd); query row
// b reads k/v row b / G with G = BH / BKV (GQA). Queries are right-aligned:
// qpos = i + Sk - Sq. Key kpos is allowed when kpos < Sk, kpos <= qpos
// (causal) and kpos > qpos - window (window > 0). Scores are
// s = cap * tanh(scale * q.k / cap) with a softcap, scale * q.k without.
// The softmax is taken online with fp32 running max m, sum l and output
// accumulator; a key tile with no allowed key is never visited, so a
// sliding window costs O(Sq * window); a row with no allowed key gives 0.
// The output is in q's dtype. The caller picks one of three kernels
// (flash_attention.py::kernel_path) and launches it once per call. For
// training, the bf16 kernels also write each row's logsumexp (an optional
// (BH, Sq) fp32 pointer; natural log, of the scores as the softmax takes
// them; +inf on a row with no allowed key), which the backward kernels
// (csrc/flash_attention_bwd.cu) read in place of a pass of their own; the
// serving path passes null and writes nothing more. The mbarrier, TMA and
// wgmma helpers are csrc/hopper.cuh's, shared with the backward.
//
// Bound on an H100. Prefill is bound by operations: at qwen3-8b (Sq = Sk =
// 4096, 32 heads, hd 128, causal) a call does 4 * hd flops for each of the
// 268M allowed (query, key) pairs of each head, 137 GFLOP, 0.14 ms at the
// bf16 tensor-core peak, against 84 MB moved. Decoding (Sq * G <= 16 rows
// per k/v head) is bound by the bytes of k and v: 134 MB at qwen3-8b's
// B = 8, Sk = 4096, 0.040 ms at 3.35 TB/s.
//
// bf16 prefill (flash_wgmma_kernel), the design of FlashAttention-3: a
// block owns 128 query rows of one head, 64 rows for each of two consumer
// warpgroups; a producer warp keeps TMA loads of the 128-key k and v tiles
// in flight in a ring of kWStages stages (mbarriers for full and empty),
// through 3-D tensor maps (hd, S, rows) so that a tile past Sk reads zeros
// of its own head. S = Q K^T is wgmma with both operands in shared memory; the
// online softmax runs in registers in log2 units (exp2); P, rounded to
// bf16, stays in registers as the A operand of O += P V (wgmma, V read
// MN-major). The softmax of tile j overlaps the P V product of tile j - 1
// on the tensor cores; the two warpgroups' products interleave there
// unforced (taking turns through named barriers, FlashAttention-3's
// ping-pong, measured no faster). setmaxnreg moves registers from the
// producer to the consumers. The swizzle is 128 B for hd 64 and 128 (two 64-column chunks
// at 128) and 64 B for hd 32, the same in the tensor maps and in the wgmma
// descriptors.
//
// bf16 decode (flash_decode_kernel): the Sq * G query rows that share one
// k/v head are packed into one 16-row mma.sync tile, so k and v are read
// from device memory once per call, not G times. The allowed key range of
// each (batch, k/v head) is split over the 8 blocks of a thread-block
// cluster; each block streams its keys through a three-stage ring of
// cp.async copies, its four warps taking 16 keys of each 64-key stage. The
// warps' (m, l, O) partials merge in shared memory, and the blocks'
// through distributed shared memory by the log-sum-exp rule, each block
// finishing hd / 8 columns: one launch, no scratch in device memory.
//
// fp32 (flash_f32_kernel): a block of 256 threads owns 64 query rows and
// walks key tiles of 32; q, k, v and P tiles sit in shared memory with odd
// row strides, each thread holds a 4 x 2 tile of S and a 4 x hd/16 tile of
// O, and every product is an fp32 FMA: no tensor cores, no TF32.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr float kNeg = -1e30f;                   // a masked score (fp32)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                                    // (BH, Sq) or null
  int Sq, Sk, G;
  int causal, window;
  float scale, softcap;
  float scale_log2;                              // scale * log2 e
  float scale_over_cap, cap_log2;                // scale / cap, cap * log2 e
};

__device__ __forceinline__ bool allowed(const Params& p, int kpos, int qpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// The key tiles [lo, hi) of `bk` keys that hold an allowed key for some
// query row in [q0, q1).
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int q1,
                                          int bk, int& lo, int& hi) {
  const int off = p.Sk - p.Sq;
  int klo = 0, khi = p.Sk - 1;
  if (p.causal) khi = min(khi, q1 - 1 + off);
  if (p.window > 0) klo = max(klo, q0 + off - p.window + 1);
  lo = hi = 0;
  if (khi >= klo) {
    lo = klo / bk;
    hi = khi / bk + 1;
  }
}

// Whether every key in [k0, k1) is allowed for every query row in [q0, q1),
// so that the tile needs no per-element mask.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  const int off = p.Sk - p.Sq;
  return k1 <= p.Sk && (!p.causal || k1 - 1 <= q0 + off) &&
         (p.window <= 0 || k0 > q1 - 1 + off - p.window);
}

// fp32 path: masked score, online-softmax weight: 0 for a masked score.
__device__ __forceinline__ float weight(float s, float m) {
  return s == kNeg ? 0.f : expf(s - m);
}

__device__ __forceinline__ float cap(const Params& p, float s) {
  s *= p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

// bf16 paths: the score in log2 units, log2 e * cap(scale * s). The
// kernels take CAP (softcap > 0) as a template argument, so that the
// softmax's element loops hold no branch. The tanh is the hardware's
// approximation: its relative error keeps a score's error far below the
// bf16 rounding of P at the scores attention sees (|scale * s| << cap),
// and gemma2-27b's cases need the same atol with it as with tanhf
// (PERF.md, PR 13).
template <bool CAP>
__device__ __forceinline__ float score2(const Params& p, float s) {
  if constexpr (CAP) return p.cap_log2 * tanh_approx(s * p.scale_over_cap);
  return s * p.scale_log2;
}

// Folds a new tile's row maximum mx (quad-reduced) into the running max m;
// returns the factor that rescales the earlier sums and sets mu, the max
// the new weights are taken against (0 while a row has seen no allowed key,
// so that exp2(-inf - mu) = 0 and no inf - inf arises).
// A row's logsumexp in natural-log units from its running max m and sum l
// in log2 units (l against m): +inf for a row with no allowed key (l = 0),
// so that the backward's exp(s - lse) is 0 there whatever the mask.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : INFINITY;
}

__device__ __forceinline__ float fold_max(float& m, float mx, float& mu) {
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
  mu = mx == -INFINITY ? 0.f : mx;
  const float alpha = ex2(m - mu);
  m = mx;
  return alpha;
}

// ----------------------------------------------------- bf16 prefill, wgmma
constexpr int kWQ = 128;                         // query rows per block
constexpr int kWK = 128;                         // keys per tile
constexpr int kWStages = 2;                      // k/v ring depth
constexpr int kWThreads = 384;                   // 2 consumer + 1 producer WG
constexpr int kConsumers = 256;

// Shared-memory layout of one 128-row tile (q, k or v), as hopper::Tile
// lays it out: hd split into chunks of CW columns, each chunk 128 rows of
// PITCH bytes, swizzled.
template <int HD>
struct WLayout : Tile<HD, kWQ> {
  static_assert(kWQ == kWK, "q and k/v tiles share one layout");
  static constexpr int TILE = Tile<HD, kWQ>::BYTES;
  // q, the k and v stages, mbarriers, 1024 B to align the base
  static constexpr int SMEM = (1 + 2 * kWStages) * TILE + 256 + 1024;
};

// s (64 x 128) = this warpgroup's 64 q rows times the 128 k rows of a tile.
template <int HD>
__device__ __forceinline__ void qk_issue(float (&s)[64], uint32_t q,
                                         uint32_t k) {
  using L = WLayout<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t at = (kk * 16 / L::CW) * L::CHUNK + (kk * 16 % L::CW) * 2;
    wgmma_ss_n128(s, gmma_desc(q + at, 16, L::SBO, L::SWZ),
                  gmma_desc(k + at, 16, L::SBO, L::SWZ), kk > 0);
  }
}

// o (64 x HD) += P (64 x 128 bf16, A fragments in registers) times the 128
// v rows of a tile, read MN-major: 16 keys per step, the hd chunks LBO
// apart.
template <int HD>
__device__ __forceinline__ void pv_issue(float (&o)[HD / 2],
                                         const uint32_t (&pf)[32],
                                         uint32_t v) {
  using L = WLayout<HD>;
#pragma unroll
  for (int kk = 0; kk < kWK / 16; ++kk) {
    const uint64_t d =
        gmma_desc(v + kk * 16 * L::PITCH, L::CHUNK, L::SBO, L::SWZ);
    wgmma_rs<HD>(o, pf + 4 * kk, d);
  }
}

// Scales and masks this thread's part of a 64 x 128 score tile in place
// and turns it into exp2 weights against the new running max; folds the
// tile into m and l and returns each row's rescale factor in alpha. MASK:
// the tile is not wholly allowed, so each element is tested.
// Accumulator layout: s[4j + 2i + c] is row g + 8i, column 8j + 2t + c.
template <bool CAP, bool MASK>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[64],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             const int (&qpos)[2], int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = score2<CAP>(p, s[4 * j + e]);
      if (MASK && !allowed(p, k0 + 8 * j + 2 * t + (e & 1), qpos[e >> 1]))
        x = -INFINITY;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    alpha[i] = fold_max(m[i], mx[i], mu[i]);
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(s[4 * j + e] - mu[e >> 1]);
      l[e >> 1] += s[4 * j + e];
    }
}

template <bool CAP>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[64],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             const int (&qpos)[2], bool full,
                                             int t) {
  if (full)
    softmax_tile<CAP, false>(p, s, m, l, alpha, k0, qpos, t);
  else
    softmax_tile<CAP, true>(p, s, m, l, alpha, k0, qpos, t);
}

// P as wgmma A fragments: 16 keys per step, the layout of mma.sync's A.
__device__ __forceinline__ void to_fragments(const float (&s)[64],
                                             uint32_t (&pf)[32]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) pf[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using L = WLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* sQ = base;
  uint8_t* sK = sQ + L::TILE;                    // kWStages tiles
  uint8_t* sV = sK + kWStages * L::TILE;         // kWStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kWStages * L::TILE);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kWStages;
  uint64_t* empty_k = full_v + kWStages;
  uint64_t* empty_v = empty_k + kWStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWQ;   // longest rows first
  int kt_lo, kt_hi;
  key_tiles(p, q0, min(q0 + kWQ, p.Sq), kWK, kt_lo, kt_hi);
  const int ntiles = kt_hi - kt_lo;              // walked from kt_hi - 1 down
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, kConsumers);
      mbar_init(empty_v + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers && ntiles > 0) {
      const int kv = bh / p.G;
      mbar_expect_tx(full_q, L::TILE);
      for (int c = 0; c < L::NCH; ++c)
        tma_load3(sQ + c * L::CHUNK, &tq, full_q, c * L::CW, q0, bh);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kWStages, parity = ((i / kWStages) & 1) ^ 1;
        const int k0 = (kt_hi - 1 - i) * kWK;
        mbar_wait(empty_k + s, parity);
        mbar_expect_tx(full_k + s, L::TILE);
        for (int c = 0; c < L::NCH; ++c)
          tma_load3(sK + s * L::TILE + c * L::CHUNK, &tk, full_k + s,
                    c * L::CW, k0, kv);
        mbar_wait(empty_v + s, parity);
        mbar_expect_tx(full_v + s, L::TILE);
        for (int c = 0; c < L::NCH; ++c)
          tma_load3(sV + s * L::TILE + c * L::CHUNK, &tv, full_v + s,
                    c * L::CW, k0, kv);
      }
    }
  } else {
    // ---------------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, ct = tid % 128;
    const int lane = ct % 32, g = lane >> 2, t = lane & 3;
    const int rb = q0 + wg * 64;                 // this warpgroup's rows
    const int rb1 = min(rb + 64, p.Sq);
    const int r0 = rb + (ct / 32) * 16 + g;      // rows r0 and r0 + 8
    const int off = p.Sk - p.Sq;
    const int qpos[2] = {r0 + off, r0 + 8 + off};

    float o[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    if (ntiles > 0) {
      const uint32_t q_at = smem_addr(sQ) + wg * 64 * L::PITCH;
      const uint32_t k_at = smem_addr(sK), v_at = smem_addr(sV);
      float s[64];
      uint32_t pf[32];
      mbar_wait(full_q, 0);

      // tile 0: S, softmax, P
      int k0 = (kt_hi - 1) * kWK;
      mbar_wait(full_k, 0);
      wg_fence();
      qk_issue<HD>(s, q_at, k_at);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int x = 0; x < 64; ++x) keep(s[x]);
      mbar_arrive(empty_k);
      softmax_tile<CAP>(p, s, m, l, alpha, k0, qpos,
                        tile_full(p, rb, rb1, k0, k0 + kWK), t);
      to_fragments(s, pf);

      // tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} in flight together;
      // the softmax of S_i runs while P V is on the tensor cores
      for (int i = 1; i < ntiles; ++i) {
        const int st = i % kWStages, ps = (i - 1) % kWStages;
        k0 = (kt_hi - 1 - i) * kWK;
        mbar_wait(full_k + st, (i / kWStages) & 1);
        mbar_wait(full_v + ps, ((i - 1) / kWStages) & 1);
        wg_fence();
        qk_issue<HD>(s, q_at, k_at + st * L::TILE);
        wg_commit();
        pv_issue<HD>(o, pf, v_at + ps * L::TILE);
        wg_commit();
        wg_wait<1>();                            // S_i is in
#pragma unroll
        for (int x = 0; x < 64; ++x) keep(s[x]);
        mbar_arrive(empty_k + st);
        softmax_tile<CAP>(p, s, m, l, alpha, k0, qpos,
                          tile_full(p, rb, rb1, k0, k0 + kWK), t);
        wg_wait<0>();                            // P_{i-1} V_{i-1} is in
#pragma unroll
        for (int x = 0; x < HD / 2; ++x) keep(o[x]);
#pragma unroll
        for (int x = 0; x < 32; ++x) keep(pf[x]);
        mbar_arrive(empty_v + ps);
#pragma unroll
        for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
        to_fragments(s, pf);
      }
      const int last = (ntiles - 1) % kWStages;
      mbar_wait(full_v + last, ((ntiles - 1) / kWStages) & 1);
      wg_fence();
      pv_issue<HD>(o, pf, v_at + last * L::TILE);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) keep(o[x]);
#pragma unroll
      for (int x = 0; x < 32; ++x) keep(pf[x]);
      mbar_arrive(empty_v + last);
    }

    auto* O = static_cast<__nv_bfloat16*>(p.o) +
              static_cast<size_t>(bh) * p.Sq * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      const int r = r0 + 8 * i;
      if (r < p.Sq) {
        if (p.lse != nullptr && t == 0)
          p.lse[static_cast<size_t>(bh) * p.Sq + r] = row_lse(m[i], l[i]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(O + static_cast<size_t>(r) * HD +
                                       8 * j + 2 * t) =
              pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// ------------------------------------------- bf16 decode, split keys
constexpr int kDR = 16;                          // packed query rows
constexpr int kDK = 64;                          // keys per stage
constexpr int kDStages = 3;
constexpr int kSplit = 8;                        // blocks per cluster
constexpr int kDWarps = 4;

template <int HD>
struct DLayout {
  static constexpr int LD = HD + 8;              // padded row, bf16
  static constexpr int QBYTES = kDR * LD * 2;
  static constexpr int STAGE = 2 * kDK * LD * 2; // k then v
  static constexpr int SMEM = QBYTES + kDStages * STAGE;
  // after the key loop the ring holds the warps' (m, l, O), then the
  // block's, which the other blocks of the cluster read
  static constexpr int WPART = kDWarps * kDR * (HD + 2) * 4;
  static constexpr int BPART = kDR * (HD + 2) * 4;
  static_assert(WPART + BPART <= kDStages * STAGE, "ring too small");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Keys [k0, k0 + kDK) of k and v into one ring stage, rows past Sk zeroed.
template <int HD>
__device__ __forceinline__ void load_stage(__nv_bfloat16* s,
                                           const __nv_bfloat16* K,
                                           const __nv_bfloat16* V, int k0,
                                           int Sk, int tid) {
  constexpr int LD = DLayout<HD>::LD, kChunks = HD / 8;
  for (int c = tid; c < kDK * kChunks; c += kDWarps * 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = k0 + r < Sk;
    const size_t at = static_cast<size_t>(ok ? k0 + r : 0) * HD + col;
    cp_async16(s + r * LD + col, K + at, ok);
    cp_async16(s + (kDK + r) * LD + col, V + at, ok);
  }
}

template <int HD, bool CAP>
__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kDWarps * 32) flash_decode_kernel(const Params p) {
  using L = DLayout<HD>;
  constexpr int LD = L::LD, KD = HD / 16, NO = HD / 8;
  extern __shared__ uint4 smem_u4[];
  auto* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_u4) + L::QBYTES;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int kv = blockIdx.y;
  const int R = p.Sq * p.G;                      // live packed rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // packed row r is query row kv * R + r of the flat (BH * Sq, hd) q:
  // head kv * G + r / Sq at position r % Sq
  const auto* Q = static_cast<const __nv_bfloat16*>(p.q) +
                  static_cast<size_t>(kv) * R * HD;
  const auto* K = static_cast<const __nv_bfloat16*>(p.k) +
                  static_cast<size_t>(kv) * p.Sk * HD;
  const auto* V = static_cast<const __nv_bfloat16*>(p.v) +
                  static_cast<size_t>(kv) * p.Sk * HD;

  int lo, hi;                                    // this call's key tiles ...
  key_tiles(p, 0, p.Sq, kDK, lo, hi);
  const int per = (hi - lo + kSplit - 1) / kSplit;
  const int t0 = lo + split * per;               // ... and this block's
  const int nt = max(0, min(hi, t0 + per) - t0);

  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < nt)
      load_stage<HD>(reinterpret_cast<__nv_bfloat16*>(ring + s * L::STAGE),
                     K, V, (t0 + s) * kDK, p.Sk, tid);
    cp_async_commit();
  }
  for (int c = tid; c < kDR * HD / 8; c += kDWarps * 32) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < R)
      x = *reinterpret_cast<const uint4*>(Q + static_cast<size_t>(r) * HD +
                                          col);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = x;
  }
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], sQ + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;                     // a dead row sees no key
    qpos[i] = r < R ? r % p.Sq + p.Sk - p.Sq : -0x40000000;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < nt; ++it) {
    const int next = it + kDStages - 1;
    if (next < nt)
      load_stage<HD>(
          reinterpret_cast<__nv_bfloat16*>(ring + (next % kDStages) *
                                                      L::STAGE),
          K, V, (t0 + next) * kDK, p.Sk, tid);
    cp_async_commit();
    cp_async_wait<kDStages - 1>();               // stage `it` has landed
    __syncthreads();
    const auto* k_s = reinterpret_cast<const __nv_bfloat16*>(
                          ring + (it % kDStages) * L::STAGE) +
                      warp * 16 * LD;            // this warp's 16 keys
    const auto* v_s = k_s + kDK * LD;
    const int k0 = (t0 + it) * kDK + warp * 16;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, k_s + ((lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
    const bool full = tile_full(p, 0, p.Sq, k0, k0 + 16);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = score2<CAP>(p, s[n][e]);
        if (!full && !allowed(p, k0 + n * 8 + 2 * t + (e & 1), qpos[e >> 1]))
          x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = fold_max(m[i], mx[i], mu[i]);
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - mu[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                           pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, v_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
    __syncthreads();                             // stage free for reuse
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' partials into the ring, merged into the block's
  float* wm = reinterpret_cast<float*>(ring);    // [warp][row]
  float* wl = wm + kDWarps * kDR;
  float* wo = wl + kDWarps * kDR;                // [warp][row][HD]
  float* bm = wo + kDWarps * kDR * HD;           // [row]
  float* bl = bm + kDR;
  float* bo = bl + kDR;                          // [row][HD]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int r = warp * kDR + g + 8 * i;
    if (t == 0) {
      wm[r] = m[i];
      wl[r] = l[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      wo[r * HD + n * 8 + 2 * t] = o[n][2 * i];
      wo[r * HD + n * 8 + 2 * t + 1] = o[n][2 * i + 1];
    }
  }
  __syncthreads();
  for (int x = tid; x < kDR * HD; x += kDWarps * 32) {
    const int r = x / HD, c = x % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) M = fmaxf(M, wm[w * kDR + r]);
    const float mu = M == -INFINITY ? 0.f : M;
    float sl = 0.f, so = 0.f;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) {
      const float f = ex2(wm[w * kDR + r] - mu);
      sl += wl[w * kDR + r] * f;
      so += wo[(w * kDR + r) * HD + c] * f;
    }
    bo[r * HD + c] = so;
    if (c == 0) {
      bm[r] = M;
      bl[r] = sl;
    }
  }
  cluster.sync();                                // every block's partial

  // this block finishes columns [split * CS, split * CS + CS) of each row
  constexpr int CS = HD / kSplit;
  auto* O = static_cast<__nv_bfloat16*>(p.o) + static_cast<size_t>(kv) * R * HD;
  for (int x = tid; x < kDR * CS; x += kDWarps * 32) {
    const int r = x / CS, c = split * CS + x % CS;
    if (r >= R) continue;
    float M = -INFINITY;
    for (int b = 0; b < kSplit; ++b)
      M = fmaxf(M, cluster.map_shared_rank(bm, b)[r]);
    const float mu = M == -INFINITY ? 0.f : M;
    float sl = 0.f, so = 0.f;
    for (int b = 0; b < kSplit; ++b) {
      const float* rm = cluster.map_shared_rank(bm, b);
      const float f = ex2(rm[r] - mu);
      sl += rm[kDR + r] * f;                     // bl
      so += rm[2 * kDR + r * HD + c] * f;        // bo
    }
    O[static_cast<size_t>(r) * HD + c] =
        __float2bfloat16_rn(sl > 0.f ? so / sl : 0.f);
    if (p.lse != nullptr && c == 0)              // split 0's first column
      p.lse[static_cast<size_t>(kv) * R + r] = row_lse(M, sl);
  }
  cluster.sync();                                // no block leaves while
}                                                // another reads its memory

// ---------------------------------------------------------------- fp32 path
constexpr int kBQ = 64;                          // query rows per block (fp32)
constexpr int kBK32 = 32;                        // keys per tile (fp32)
constexpr int kT32 = 16;                         // 16 x 16 threads

template <int HD>
__global__ void __launch_bounds__(kT32 * kT32) flash_f32_kernel(Params p) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = kBK32 + 1;
  constexpr int RI = kBQ / kT32;                 // 4 rows per thread
  constexpr int KJ = kBK32 / kT32;               // 2 keys per thread
  constexpr int DC = HD / kT32;                  // output columns per thread
  extern __shared__ float smem_f[];
  float* sQ = smem_f;                            // kBQ x LDQ
  float* sK = sQ + kBQ * LDQ;                    // kBK32 x LDK
  float* sV = sK + kBK32 * LDK;                  // kBK32 x LDV
  float* sP = sV + kBK32 * LDV;                  // kBQ x LDP

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q1 = min(q0 + kBQ, p.Sq);
  const float* Q = static_cast<const float*>(p.q) +
                   static_cast<size_t>(bh) * p.Sq * HD;
  const float* K = static_cast<const float*>(p.k) +
                   static_cast<size_t>(bh / p.G) * p.Sk * HD;
  const float* V = static_cast<const float*>(p.v) +
                   static_cast<size_t>(bh / p.G) * p.Sk * HD;
  float* O = static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.Sq * HD;
  const int tx = threadIdx.x % kT32, ty = threadIdx.x / kT32;
  const int tid = threadIdx.x, nthreads = kT32 * kT32;
  const int off = p.Sk - p.Sq;

  int kt_lo, kt_hi;
  key_tiles(p, q0, q1, kBK32, kt_lo, kt_hi);

  for (int x = tid; x < kBQ * HD; x += nthreads) {
    const int r = x / HD, d = x % HD;
    sQ[r * LDQ + d] = q0 + r < p.Sq ? Q[static_cast<size_t>(q0 + r) * HD + d]
                                    : 0.f;
  }
  float o[RI][DC], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();                             // last tile fully read
    for (int x = tid; x < kBK32 * HD; x += nthreads) {
      const int r = x / HD, d = x % HD;
      const bool ok = k0 + r < p.Sk;
      const size_t at = static_cast<size_t>(k0 + r) * HD + d;
      sK[r * LDK + d] = ok ? K[at] : 0.f;
      sV[r * LDV + d] = ok ? V[at] : 0.f;
    }
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + kT32 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = sK[(tx + kT32 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool full = tile_full(p, q0, q1, k0, k0 + kBK32);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + kT32 * i + off;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float x = cap(p, s[i][j]);
        if (!full && !allowed(p, k0 + tx + kT32 * j, qpos)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < kT32; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float w = weight(s[i][j], mx);
        sP[(ty + kT32 * i) * LDP + tx + kT32 * j] = w;
        sum += w;
      }
#pragma unroll
      for (int w = 1; w < kT32; w <<= 1)
        sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK32; ++j) {
      float pv[RI], vv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + kT32 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[j * LDV + tx + kT32 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + kT32 * i;
    if (r < p.Sq) {
      const float lv = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        O[static_cast<size_t>(r) * HD + tx + kT32 * c] = o[i][c] / lv;
    }
  }
}

// ------------------------------------------------------------------ launch
enum Path { kPathF32 = 0, kPathWgmma = 1, kPathDecode = 2 };

template <int HD, bool CAP>
cudaError_t launch_bf16(const Params& p, int BH, int BKV, int path,
                        cudaStream_t stream) {
  if (path == kPathWgmma) {
    static bool opted = false;
    using L = WLayout<HD>;
    cudaError_t e = opt_in(flash_wgmma_kernel<HD, CAP>, L::SMEM, opted);
    if (e != cudaSuccess) return e;
    CUtensorMap tq, tk, tv;
    if (!tensor_map<HD, kWQ>(&tq, p.q, p.Sq, BH) ||
        !tensor_map<HD, kWK>(&tk, p.k, p.Sk, BKV) ||
        !tensor_map<HD, kWK>(&tv, p.v, p.Sk, BKV))
      return cudaErrorInvalidValue;
    const dim3 grid((p.Sq + kWQ - 1) / kWQ, BH);
    flash_wgmma_kernel<HD, CAP>
        <<<grid, kWThreads, L::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
  }
  static bool opted = false;
  using L = DLayout<HD>;
  cudaError_t e = opt_in(flash_decode_kernel<HD, CAP>, L::SMEM, opted);
  if (e != cudaSuccess) return e;
  flash_decode_kernel<HD, CAP>
      <<<dim3(kSplit, BKV), kDWarps * 32, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Params& p, int BH, int BKV, int path,
                   cudaStream_t stream) {
  if (path != kPathF32)
    return p.softcap > 0.f ? launch_bf16<HD, true>(p, BH, BKV, path, stream)
                           : launch_bf16<HD, false>(p, BH, BKV, path, stream);
  static bool opted = false;
  const size_t smem = sizeof(float) * ((kBQ + kBK32) * (HD + 1) +
                                       kBK32 * HD + kBQ * (kBK32 + 1));
  cudaError_t e = opt_in(flash_f32_kernel<HD>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, BH);
  flash_f32_kernel<HD><<<grid, kT32 * kT32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). q/k/v/o are device pointers of
// contiguous, 16-byte aligned tensors, all fp32 for `path` 0 (fp32) and all
// bf16 for paths 1 (wgmma) and 2 (decode, Sq * BH / BKV <= 16); hd must be
// 32, 64 or 128; `stream` is a cudaStream_t. `lse` (BH, Sq) fp32 may be
// null; given on a bf16 path, the kernel also writes each row's logsumexp
// there (natural log, of the scores as the softmax takes them; +inf for a
// row with no allowed key), which the backward reads; the fp32 path takes
// none. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or path the kernels do not take.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int BH,
                                       int BKV, int Sq, int Sk, int hd,
                                       int path, int causal, int window,
                                       float scale, float softcap,
                                       void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BH < 0 || BKV < 1 || BH % BKV != 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = BH / BKV;
  const bool ok = (path == kPathF32 && BH <= 65535 && lse == nullptr) ||
                  (path == kPathWgmma && Sk > 0 && BH <= 65535) ||
                  (path == kPathDecode && Sq * G <= kDR && BKV <= 65535);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, lse, Sq, Sk, G, causal, window, scale, softcap,
                 scale * kLog2e,
                 softcap > 0.f ? scale / softcap : 0.f, softcap * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch<32>(p, BH, BKV, path, s); break;
    case 64: e = launch<64>(p, BH, BKV, path, s); break;
    case 128: e = launch<128>(p, BH, BKV, path, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
