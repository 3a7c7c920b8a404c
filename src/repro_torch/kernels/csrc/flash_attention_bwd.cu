// Flash attention backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma fed by TMA, fp32 accumulate), fp32 exactly on the FMA units.
//
// The backward of csrc/flash_attention.cu's function. The reference's
// Pallas kernel (repro/kernels/flash_attention.py::flash_attention) has no
// VJP: the reference trains through jnp autodiff of its einsum oracle, so
// this kernel replaces that autodiff; its plain version is
// ref.flash_attention_bwd_ref. q (BH, Sq, hd), k/v (BKV, Sk, hd), the
// forward's output o and its cotangent g (BH, Sq, hd), all fp32 or all
// bf16 -> dq (BH, Sq, hd), dk/dv (BKV, Sk, hd) in the same dtype. The
// masks are the forward's: queries right-aligned (qpos = i + Sk - Sq), key
// kpos allowed when kpos < Sk, kpos <= qpos (causal), kpos > qpos - window
// (window > 0); scores s = cap tanh(scale q.k / cap) with a softcap. With
// P = softmax(s) (0 on a row with no allowed key):
//   D = rowsum(g o), dP = g V^T, dS = P (dP - D) (1 - tanh^2 with a cap),
//   dQ = scale dS K, dK = scale dS^T Q, dV = P^T g,
// dK and dV summed over the G = BH / BKV query heads of each k/v head.
//
// Bound on an H100: operations. At qwen3-8b's train shape (B 4, 32 heads
// over 8 k/v heads, S 1024, hd 128, causal) the function needs 5 products
// of 2 hd flops for each of 524,800 allowed pairs of each head, 86.0
// GFLOP, 0.087 ms at the bf16 tensor-core peak, against ~168 MB moved.
//
// Design: two launches, the dq kernel first, no atomics, repeatable bit
// for bit.
// - bf16 (the training path), in the shape of the forward's
//   flash_wgmma_kernel: 384 threads, two consumer warpgroups and a
//   producer warp. Each P is exp2(score in log2 units - the row's
//   logsumexp), the logsumexp the forward kernel saved (`lse`, natural
//   log, +inf on a row with no allowed key): no pass over the keys to find
//   it, so the two kernels run 7 products where the function needs 5 (S
//   and dP in both); the softcap's tanh is the forward's hardware tanh.
//   - dq kernel: a block owns 128 query rows of one head, 64 for each
//     consumer warpgroup, its q and dO tiles loaded once by TMA; the
//     producer streams 64-key tiles of k and v through a ring of 3 stages
//     (mbarriers for full and empty). Each tile: S = Q K^T and dP = dO V^T
//     on wgmma from shared memory, dS in registers, rounded to bf16 as the
//     A operand of dQ += dS K (K read MN-major), which runs on the tensor
//     cores behind the next tile's S and dP. Each warp first forms D =
//     rowsum(dO o) of its 16 rows from device memory; the kernel writes each
//     row's logsumexp (log2 units) and D to a stats scratch (2, BH, Sq
//     padded to 128) for the dkv kernel. Longest rows first.
//   - dkv kernel, as FlashAttention-3 does it: a block owns 128 keys of one
//     k/v head, 64 for each consumer warpgroup, its k and v tiles loaded
//     once; the producer streams, over the G query heads of the k/v head
//     and only the 64-row query tiles that may see its keys (a sliding
//     window costs O(S window)), the q and dO tiles with their logsumexp
//     and D (2-D tensor maps of the stats) through a ring of 3 stages.
//     Each tile: S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T rounded
//     to bf16 in registers as the A operands of dV += P^T dO and dK += dS^T
//     Q (dO and Q read MN-major). Longest key ranges first (causal: the
//     first keys).
//   - 3-D tensor maps (hd, S, rows) with the forward's swizzles (128 B at
//     hd 64 and 128, 64 B at 32), so that a tile past Sq or Sk reads zeros
//     of its own head; positions are masked as the forward masks them, a
//     warpgroup skips a tile with no allowed pair, and rows past Sq carry
//     lse = +inf (P = 0). setmaxnreg moves registers from the producer to
//     the consumers.
//   - At qwen3-8b's train shape (PERF.md) the dkv kernel runs its 4
//     products at ~50% of the bf16 peak, the dq kernel its 3 at ~26%;
//     what holds the dq kernel back is not measured (blocks of one
//     consumer warpgroup, two an SM, were no faster). The dkv kernel runs
//     its two pairs of products one after the other in each warpgroup,
//     the other warpgroup filling the gaps.
// - fp32 (exact, FMA units, no TF32): the dq kernel,
//   a block 64 query rows (256 threads, each 4 rows x 2 keys of a score
//   tile and 4 rows x hd/16 columns of dQ), makes each row's logsumexp in a
//   first pass over its key tiles and writes it with D to a (2, BH, Sq)
//   scratch, then recomputes S and dP a tile of 32 keys at a time, dS
//   through shared memory; the dkv kernel, a block 64 keys over the G query
//   heads and the 32-row query tiles that may see them. The products that
//   reduce over hd read 16-byte vectors along hd (rows padded to hd + 4
//   floats), the ones that reduce over keys or rows read vectors of the
//   output columns; S is summed over hd in the same order in both kernels.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                    // 16 x 16
constexpr int kAQ = 64, kAK = 32;                // dq kernel: rows, keys
constexpr int kBK = 64, kBQ = 32;                // dkv kernel: keys, rows

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                                    // fp32: (BH, Sq) scratch
  float* delta;                                  // fp32: (BH, Sq) scratch
  const float* lse_in;                           // bf16: the forward's (BH, Sq)
  float* stats;                                  // bf16: (2, BH, Sq_pad)
  int Sq, Sk, G, Sq_pad;
  int causal, window;
  float scale, softcap;
  float scale_log2;                              // scale * log2 e
  float scale_over_cap, cap_log2;                // scale / cap, cap * log2 e
};

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;              // shared row stride, floats
  static constexpr int CW = HD / 16;             // columns a thread owns
  static constexpr int VW = CW < 4 ? CW : 4;     // columns a vector access
  static constexpr int NC = CW / VW;             // vectors a thread owns
  // the first of the VW columns of vector c of thread tx
  __device__ static int col(int tx, int c) { return (c * 16 + tx) * VW; }
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

// The query tiles [lo, hi) of `bq` rows that hold a row to which some key
// in [k0, k1) is allowed.
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int k1,
                                            int bq, int& lo, int& hi) {
  const int off = p.Sk - p.Sq;
  int ilo = 0, ihi = p.Sq;                       // rows [ilo, ihi)
  if (p.causal) ilo = max(ilo, k0 - off);
  if (p.window > 0) ihi = min(ihi, k1 - 1 + p.window - off);
  lo = hi = 0;
  if (ihi > ilo) {
    lo = ilo / bq;
    hi = (ihi + bq - 1) / bq;
  }
}

// The score of raw product s and, in `fac`, d(score)/d(scale s) / scale:
// 1 - tanh^2 with a softcap, else 1.
__device__ __forceinline__ float score(const Params& p, float s, float& fac) {
  s *= p.scale;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    fac = 1.f - t * t;
    return p.softcap * t;
  }
  fac = 1.f;
  return s;
}

// Rows [0, nrows) of a (rows, HD) fp32 tensor at src into shared rows of
// stride LD; rows from `valid` on are zeros. 16-byte loads.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int valid, int nrows) {
  constexpr int PER_ROW = HD / 4, LD = Cfg<HD>::LD;
  for (int c = threadIdx.x; c < nrows * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + col) =
        r < valid ? *reinterpret_cast<const float4*>(
                        src + static_cast<size_t>(r) * HD + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[c][e] += w * row[col(tx, c) + e] for the thread's output columns.
template <int HD>
__device__ __forceinline__ void axpy_cols(float (&acc)[Cfg<HD>::NC]
                                                     [Cfg<HD>::VW],
                                          float w, const float* row, int tx) {
  using C = Cfg<HD>;
#pragma unroll
  for (int c = 0; c < C::NC; ++c) {
    const float* at = row + C::col(tx, c);
    if constexpr (C::VW == 4) {
      const float4 x = ld4(at);
      acc[c][0] = fmaf(w, x.x, acc[c][0]);
      acc[c][1] = fmaf(w, x.y, acc[c][1]);
      acc[c][2] = fmaf(w, x.z, acc[c][2]);
      acc[c][3] = fmaf(w, x.w, acc[c][3]);
    } else {
      const float2 x = *reinterpret_cast<const float2*>(at);
      acc[c][0] = fmaf(w, x.x, acc[c][0]);
      acc[c][1] = fmaf(w, x.y, acc[c][1]);
    }
  }
}

// Rows of (rows, HD) `out` from the thread's accumulators times `mul`.
template <int HD, int R>
__device__ __forceinline__ void store_rows(
    float* out, const float (&acc)[R][Cfg<HD>::NC][Cfg<HD>::VW], int ty,
    int tx, int valid, float mul) {
  using C = Cfg<HD>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        out[static_cast<size_t>(r) * HD + C::col(tx, c) + e] =
            acc[i][c][e] * mul;
  }
}

// ------------------------------------------------------ fp32: dq kernel
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_dq_kernel(const Params p) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, RI = kAQ / 16, KJ = kAK / 16, LDS = kAK + 1;
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);   // kAQ x LD
  float* const sG = sQ + kAQ * LD;                     // kAQ x LD
  float* const sK = sG + kAQ * LD;                     // kAK x LD
  float* const sV = sK + kAK * LD;                     // kAK x LD
  float* const sS = sV + kAK * LD;                     // kAQ x LDS (dS)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kAQ;   // long rows first
  const int nq = min(kAQ, p.Sq - q0);
  const int off = p.Sk - p.Sq;
  const size_t row0 = static_cast<size_t>(bh) * p.Sq + q0;
  const float* Q = static_cast<const float*>(p.q) + row0 * HD;
  const float* O = static_cast<const float*>(p.o) + row0 * HD;
  const float* Gr = static_cast<const float*>(p.g) + row0 * HD;
  const float* K = static_cast<const float*>(p.k) +
                   static_cast<size_t>(bh / p.G) * p.Sk * HD;
  const float* V = static_cast<const float*>(p.v) +
                   static_cast<size_t>(bh / p.G) * p.Sk * HD;

  load_rows<HD>(sQ, Q, nq, kAQ);
  load_rows<HD>(sG, Gr, nq, kAQ);
  __syncthreads();

  // D = rowsum(g o) of the thread's rows (16 threads a row)
  float dl[RI], lse[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < nq)
      for (int d = tx; d < HD; d += 16)
        acc = fmaf(sG[r * LD + d], O[static_cast<size_t>(r) * HD + d], acc);
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) acc += __shfl_xor_sync(kFull, acc, w);
    dl[i] = acc;
  }

  int lo, hi;
  key_tiles(p, q0, q0 + nq, kAK, lo, hi);

  // S = Q K^T of the tile at k0 for the thread's 4 rows x 2 keys
  auto qk = [&](float (&s)[RI][KJ]) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = ld4(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = ld4(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
  };

  // pass 1: each row's logsumexp, online
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kAK;
    __syncthreads();                             // the last tile is read
    load_rows<HD>(sK, K + static_cast<size_t>(k0) * HD, p.Sk - k0, kAK);
    __syncthreads();
    float s[RI][KJ];
    qk(s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float fac;
        s[i][j] = allowed(p, k0 + tx + 16 * j, qpos) ? score(p, s[i][j], fac)
                                                     : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) sum += expf(s[i][j] - mu);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * expf(m[i] - mu) + sum;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;   // 0: no allowed key
    const int r = ty + 16 * i;
    if (tx == 0 && r < nq) {
      p.lse[row0 + r] = lse[i];
      p.delta[row0 + r] = dl[i];
    }
  }

  // pass 2: dS a tile at a time, dQ += dS K
  float acc[RI][C::NC][C::VW];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) acc[i][c][e] = 0.f;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kAK;
    __syncthreads();                             // sK, sV and sS are read
    load_rows<HD>(sK, K + static_cast<size_t>(k0) * HD, p.Sk - k0, kAK);
    load_rows<HD>(sV, V + static_cast<size_t>(k0) * HD, p.Sk - k0, kAK);
    __syncthreads();
    float s[RI][KJ], dp[RI][KJ];
    qk(s);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 gv[RI], vv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = ld4(sG + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) vv[j] = ld4(sV + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) dp[i][j] = dot4(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float ds = 0.f;
        if (allowed(p, k0 + tx + 16 * j, qpos)) {
          float fac;
          const float pr = expf(score(p, s[i][j], fac) - lse[i]);
          ds = pr * (dp[i][j] - dl[i]) * fac;
        }
        sS[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kAK; ++j) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
        axpy_cols<HD>(acc[i], sS[(ty + 16 * i) * LDS + j], sK + j * LD, tx);
    }
  }
  store_rows<HD, RI>(static_cast<float*>(p.dq) + row0 * HD, acc, ty, tx, nq,
                        p.scale);
}

// ----------------------------------------------------- fp32: dkv kernel
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkv_kernel(const Params p) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, QI = kBQ / 16, KI = kBK / 16, LDP = kBK + 1;
  extern __shared__ float4 smem4[];
  float* const sK = reinterpret_cast<float*>(smem4);   // kBK x LD
  float* const sV = sK + kBK * LD;                     // kBK x LD
  float* const sQ = sV + kBK * LD;                     // kBQ x LD
  float* const sG = sQ + kBQ * LD;                     // kBQ x LD
  float* const sP = sG + kBQ * LD;                     // kBQ x LDP
  float* const sD = sP + kBQ * LDP;                    // kBQ x LDP (dS)
  float* const sL = sD + kBQ * LDP;                    // kBQ: logsumexp
  float* const sDl = sL + kBQ;                         // kBQ: D

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int nk = min(kBK, p.Sk - k0);
  const int off = p.Sk - p.Sq;
  const size_t krow0 = static_cast<size_t>(bkv) * p.Sk + k0;
  load_rows<HD>(sK, static_cast<const float*>(p.k) + krow0 * HD, nk, kBK);
  load_rows<HD>(sV, static_cast<const float*>(p.v) + krow0 * HD, nk, kBK);

  float dk[KI][C::NC][C::VW], dv[KI][C::NC][C::VW];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  int lo, hi;
  query_tiles(p, k0, k0 + nk, kBQ, lo, hi);
  for (int h = 0; h < p.G; ++h) {
    const int bh = bkv * p.G + h;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBQ;
      const int nq = min(kBQ, p.Sq - q0);
      const size_t row0 = static_cast<size_t>(bh) * p.Sq + q0;
      __syncthreads();                           // the last tile is read
      load_rows<HD>(sQ, static_cast<const float*>(p.q) + row0 * HD, nq, kBQ);
      load_rows<HD>(sG, static_cast<const float*>(p.g) + row0 * HD, nq, kBQ);
      if (threadIdx.x < kBQ) {
        const bool ok = static_cast<int>(threadIdx.x) < nq;
        sL[threadIdx.x] = ok ? p.lse[row0 + threadIdx.x] : 0.f;
        sDl[threadIdx.x] = ok ? p.delta[row0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // S and dP for rows tx + 16 i, keys ty + 16 j
      float s[QI][KI], dp[QI][KI];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < KI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 qv[QI], gv[QI], kv[KI], vv[KI];
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          qv[i] = ld4(sQ + (tx + 16 * i) * LD + d);
          gv[i] = ld4(sG + (tx + 16 * i) * LD + d);
        }
#pragma unroll
        for (int j = 0; j < KI; ++j) {
          kv[j] = ld4(sK + (ty + 16 * j) * LD + d);
          vv[j] = ld4(sV + (ty + 16 * j) * LD + d);
        }
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int j = 0; j < KI; ++j) {
            s[i][j] = dot4(qv[i], kv[j], s[i][j]);
            dp[i][j] = dot4(gv[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const int r = tx + 16 * i;
        const int qpos = q0 + r + off;
#pragma unroll
        for (int j = 0; j < KI; ++j) {
          const int key = ty + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (r < nq && allowed(p, k0 + key, qpos)) {
            float fac;
            pr = expf(score(p, s[i][j], fac) - sL[r]);
            ds = pr * (dp[i][j] - sDl[r]) * fac;
          }
          sP[r * LDP + key] = pr;
          sD[r * LDP + key] = ds;
        }
      }
      __syncthreads();
      // dV += P^T g, dK += dS^T q for keys ty + 16 i
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          axpy_cols<HD>(dv[i], sP[r * LDP + ty + 16 * i], sG + r * LD, tx);
          axpy_cols<HD>(dk[i], sD[r * LDP + ty + 16 * i], sQ + r * LD, tx);
        }
      }
    }
  }
  store_rows<HD, KI>(static_cast<float*>(p.dk) + krow0 * HD, dk, ty, tx, nk,
                        p.scale);
  store_rows<HD, KI>(static_cast<float*>(p.dv) + krow0 * HD, dv, ty, tx, nk,
                        1.f);
}

// --------------------------------------- bf16: wgmma, fed by TMA (sm_90a)
// The two kernels in the shape of the forward's flash_wgmma_kernel: a
// block of three warpgroups owns kRows = 128 rows (dq: queries of one
// head; dkv: keys of one k/v head), 64 for each of two consumer
// warpgroups, whose tiles TMA loads once; a producer warp streams tiles of
// kCols = 64 rows of the other side (dq: k and v; dkv: q and dO with
// their logsumexp and D) through a ring of kStages stages (mbarriers for
// full and empty). Products whose operands both sit in shared memory read
// them K-major; the second product of each pair takes P or dS, rounded to
// bf16, from registers as its A operand and reads its B operand MN-major.
using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;                       // a block's own rows
constexpr int kCols = 64;                        // rows of a streamed tile
constexpr int kStages = 3;                       // ring depth
constexpr int kWThreads = 384;                   // 2 consumer + 1 producer WG
constexpr int kConsumers = 256;

template <int HD>
struct WLayout {
  using R = Tile<HD, kRows>;                     // the block's own tiles
  using C = Tile<HD, kCols>;                     // a streamed tile
  static constexpr int kStats = 2 * kCols * 4;   // lse and D of a dkv stage
  // two own tiles, kStages pairs of streamed tiles and their stats, the dq
  // kernel's D, mbarriers, 1024 B to align the base
  static constexpr int SMEM = 2 * R::BYTES + kStages * (2 * C::BYTES + kStats)
                              + kRows * 4 + 256 + 1024;
};

// Whether some pair (query row in [q0, q1), key in [k0, k1)) is allowed.
__device__ __forceinline__ bool any_allowed(const Params& p, int q0, int q1,
                                            int k0, int k1) {
  const int off = p.Sk - p.Sq;
  k1 = min(k1, p.Sk);
  if (q1 <= q0 || k1 <= k0) return false;
  int lo = k0, hi = k1 - 1;                      // the union of the rows'
  if (p.causal) hi = min(hi, q1 - 1 + off);      // allowed keys is
  if (p.window > 0) lo = max(lo, q0 + off - p.window + 1);   // contiguous
  return lo <= hi;
}

// Whether every key in [k0, k1) is allowed for every query row in [q0, q1).
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  const int off = p.Sk - p.Sq;
  return k1 <= p.Sk && (!p.causal || k1 - 1 <= q0 + off) &&
         (p.window <= 0 || k0 > q1 - 1 + off - p.window);
}

// The score of raw product s in log2 units, as the forward's bf16 kernels
// take it (scale, then the softcap through the hardware's tanh), and in
// `fac` d(score) / d(scale s): 1 - tanh^2 with a cap, else 1.
template <bool CAP>
__device__ __forceinline__ float score2(const Params& p, float s,
                                        float& fac) {
  if constexpr (CAP) {
    const float th = tanh_approx(s * p.scale_over_cap);
    fac = 1.f - th * th;
    return p.cap_log2 * th;
  }
  fac = 1.f;
  return s * p.scale_log2;
}

// s (64 x 64) = 64 rows of an own tile at a (K-major) times the 64 rows of
// a streamed tile at b (K-major), summed over hd.
template <int HD>
__device__ __forceinline__ void ss_issue(float (&s)[32], uint32_t a,
                                         uint32_t b) {
  using R = Tile<HD, kRows>;
  using C = Tile<HD, kCols>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(s, gmma_desc(a + R::k_step(kk), 16, R::SBO, R::SWZ),
                 gmma_desc(b + C::k_step(kk), 16, C::SBO, C::SWZ), kk > 0);
}

// d (64 x HD) += f (64 x 64 bf16, A fragments in registers) times the 64
// rows of a streamed tile at b, read MN-major: 16 rows a step, the hd
// chunks LBO apart.
template <int HD>
__device__ __forceinline__ void rs_issue(float (&d)[HD / 2],
                                         const uint32_t (&f)[16], uint32_t b) {
  using C = Tile<HD, kCols>;
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk)
    wgmma_rs<HD>(d, f + 4 * kk,
                 gmma_desc(b + kk * 16 * C::PITCH, C::CHUNK, C::SBO, C::SWZ));
}

// dQ += dS K alone, waited out; then K's stage is released.
template <int HD>
__device__ __forceinline__ void dq_product(float (&dq)[HD / 2],
                                           uint32_t (&f)[16], uint32_t k,
                                           uint64_t* empty) {
  wg_fence();
  rs_issue<HD>(dq, f, k);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) keep(dq[x]);
#pragma unroll
  for (int x = 0; x < 16; ++x) keep(f[x]);
  mbar_arrive(empty);
}

// A 64 x 64 accumulator tile as wgmma A fragments, rounded to bf16.
__device__ __forceinline__ void to_fragments(const float (&s)[32],
                                             uint32_t (&f)[16]) {
#pragma unroll
  for (int x = 0; x < 16; ++x) f[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
}

// dq kernel: dS in place of S for this thread's part of a 64-query x
// 64-key tile, from S, dP, the rows' logsumexp (log2 units) and D.
// Accumulator layout: s[4j + 2i + c] is row g + 8i, column 8j + 2t + c.
template <bool CAP, bool MASK>
__device__ __forceinline__ void ds_by_rows(const Params& p, float (&s)[32],
                                           const float (&dp)[32],
                                           const float (&lse2)[2],
                                           const float (&dl)[2], int k0,
                                           const int (&qpos)[2], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float fac;
      float pr = ex2(score2<CAP>(p, s[4 * j + e], fac) - lse2[i]);
      if (MASK && !allowed(p, k0 + 8 * j + 2 * t + (e & 1), qpos[i]))
        pr = 0.f;
      s[4 * j + e] = pr * (dp[4 * j + e] - dl[i]) * fac;
    }
}

// dkv kernel: P^T in place of S^T and dS^T in place of dP^T for this
// thread's part of a 64-key x 64-query tile; the columns' logsumexp (log2
// units) and D from the stage's stats.
template <bool CAP, bool MASK>
__device__ __forceinline__ void p_ds_by_cols(const Params& p, float (&s)[32],
                                             float (&dp)[32],
                                             const float* lse2,
                                             const float* dl, int q0,
                                             const int (&kpos)[2], int t) {
  const int off = p.Sk - p.Sq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      float fac;
      float pr = ex2(score2<CAP>(p, s[4 * j + e], fac) - lse2[col]);
      if (MASK && !allowed(p, kpos[e >> 1], q0 + col + off)) pr = 0.f;
      s[4 * j + e] = pr;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dl[col]) * fac;
    }
}

// The warpgroup's 64 rows of an accumulator (64 x HD) times `mul` into the
// (rows, HD) bf16 tensor out; rows from `valid` on are not written.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[HD / 2],
                                           int r0, int valid, float mul,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * HD + 8 * j +
                                   2 * t) =
          pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kWThreads, 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tg,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Params p) {
  using L = WLayout<HD>;
  using R = typename L::R;
  using C = typename L::C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* sQ = base;
  uint8_t* sG = sQ + R::BYTES;
  uint8_t* sK = sG + R::BYTES;                   // kStages tiles
  uint8_t* sV = sK + kStages * C::BYTES;         // kStages tiles
  float* sD = reinterpret_cast<float*>(sV + kStages * C::BYTES +
                                       kStages * L::kStats);   // kRows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + kRows);
  uint64_t* full_qg = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // longest first
  int kt_lo, kt_hi;
  key_tiles(p, q0, min(q0 + kRows, p.Sq), kCols, kt_lo, kt_hi);
  const int ntiles = kt_hi - kt_lo;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_qg, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, kConsumers);
      mbar_init(empty_v + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers && ntiles > 0) {
      const int kv = bh / p.G;
      mbar_expect_tx(full_qg, 2 * R::BYTES);
      for (int c = 0; c < R::NCH; ++c) {
        tma_load3(sQ + c * R::CHUNK, &tq, full_qg, c * R::CW, q0, bh);
        tma_load3(sG + c * R::CHUNK, &tg, full_qg, c * R::CW, q0, bh);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kCols;
        mbar_wait(empty_k + s, parity);
        mbar_expect_tx(full_k + s, C::BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load3(sK + s * C::BYTES + c * C::CHUNK, &tk, full_k + s,
                    c * C::CW, k0, kv);
        mbar_wait(empty_v + s, parity);
        mbar_expect_tx(full_v + s, C::BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load3(sV + s * C::BYTES + c * C::CHUNK, &tv, full_v + s,
                    c * C::CW, k0, kv);
      }
    }
  } else {
    // ---------------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, ct = tid % 128;
    const int lane = ct % 32, g = lane >> 2, t = lane & 3;
    const int rb = q0 + wg * 64;                 // this warpgroup's rows
    const int rb1 = min(rb + 64, p.Sq);
    const int w0 = rb + (ct / 32) * 16;          // this warp's rows
    const int r0 = w0 + g;                       // rows r0 and r0 + 8
    const int off = p.Sk - p.Sq;
    const int qpos[2] = {r0 + off, r0 + 8 + off};

    // D = rowsum(dO o) of the warp's 16 rows from device memory, 16 bytes
    // a lane, CH lanes a row
    constexpr int CH = HD / 8, RPP = 32 / CH;
    const size_t row0 = static_cast<size_t>(bh) * p.Sq;
#pragma unroll
    for (int pass = 0; pass < 16 / RPP; ++pass) {
      const int r = w0 + pass * RPP + lane / CH;
      float acc = 0.f;
      if (r < p.Sq) {
        const size_t at = (row0 + r) * HD + (lane % CH) * 8;
        const uint4 a = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(p.o) + at);
        const uint4 b = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(p.g) + at);
        const bf16* pa = reinterpret_cast<const bf16*>(&a);
        const bf16* pb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(pa[e]), __bfloat162float(pb[e]), acc);
      }
#pragma unroll
      for (int w = CH / 2; w >= 1; w >>= 1)
        acc += __shfl_xor_sync(kFull, acc, w);
      if (lane % CH == 0) sD[r - q0] = acc;
    }
    __syncwarp();
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      dl[i] = sD[r - q0];
      lse2[i] = r < p.Sq ? p.lse_in[row0 + r] * kLog2e : INFINITY;
      if (t == 0) {                              // for the dkv kernel
        p.stats[static_cast<size_t>(bh) * p.Sq_pad + r] = lse2[i];
        p.stats[static_cast<size_t>(gridDim.x + bh) * p.Sq_pad + r] = dl[i];
      }
    }

    float dq[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dq[x] = 0.f;
    if (ntiles > 0) {
      const uint32_t q_at = smem_addr(sQ) + wg * 64 * R::PITCH;
      const uint32_t g_at = smem_addr(sG) + wg * 64 * R::PITCH;
      const uint32_t k_at = smem_addr(sK), v_at = smem_addr(sV);
      float s[32], dp[32];
      uint32_t f[16];
      bool pending = false;                      // f waits for dQ += dS K
      int pst = 0;                               // ... of the K at stage pst
      mbar_wait(full_qg, 0);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages, par = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kCols;
        mbar_wait(full_k + st, par);
        mbar_wait(full_v + st, par);
        if (!any_allowed(p, rb, rb1, k0, k0 + kCols)) {
          if (pending) {
            dq_product<HD>(dq, f, k_at + pst * C::BYTES, empty_k + pst);
            pending = false;
          }
          mbar_arrive(empty_k + st);
          mbar_arrive(empty_v + st);
          continue;
        }
        // S_i = Q K_i^T and dP_i = dO V_i^T, with dQ += dS_{i-1} K_{i-1}
        // behind them on the tensor cores
        wg_fence();
        ss_issue<HD>(s, q_at, k_at + st * C::BYTES);
        ss_issue<HD>(dp, g_at, v_at + st * C::BYTES);
        wg_commit();
        if (pending) {
          rs_issue<HD>(dq, f, k_at + pst * C::BYTES);
          wg_commit();
          wg_wait<1>();                          // S_i and dP_i are in
        } else {
          wg_wait<0>();
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          keep(s[x]);
          keep(dp[x]);
        }
        mbar_arrive(empty_v + st);
        if (tile_full(p, rb, rb1, k0, k0 + kCols))
          ds_by_rows<CAP, false>(p, s, dp, lse2, dl, k0, qpos, t);
        else
          ds_by_rows<CAP, true>(p, s, dp, lse2, dl, k0, qpos, t);
        if (pending) {
          wg_wait<0>();                          // dQ += dS_{i-1} K_{i-1}
#pragma unroll
          for (int x = 0; x < HD / 2; ++x) keep(dq[x]);
#pragma unroll
          for (int x = 0; x < 16; ++x) keep(f[x]);
          mbar_arrive(empty_k + pst);
        }
        to_fragments(s, f);
        pending = true;
        pst = st;
      }
      if (pending) dq_product<HD>(dq, f, k_at + pst * C::BYTES, empty_k + pst);
    }
    store_acc<HD>(static_cast<bf16*>(p.dq) + row0 * HD, dq, r0, p.Sq,
                   p.scale, t);
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kWThreads, 1)
    attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap ts,
                              const Params p) {
  using L = WLayout<HD>;
  using R = typename L::R;
  using C = typename L::C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* sK = base;
  uint8_t* sV = sK + R::BYTES;
  uint8_t* sQ = sV + R::BYTES;                   // kStages tiles
  uint8_t* sG = sQ + kStages * C::BYTES;         // kStages tiles
  float* sS = reinterpret_cast<float*>(sG + kStages * C::BYTES);
  // sS: a stage's lse (log2 units) of its kCols rows, then their D
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sS) + kStages * L::kStats + kRows * 4);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kRows;             // causal: longest first
  int qt_lo, qt_hi;
  query_tiles(p, k0, min(k0 + kRows, p.Sk), kCols, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  const int items = p.G * nq;                    // (head, query tile)
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers && items > 0) {
      mbar_expect_tx(full_kv, 2 * R::BYTES);
      for (int c = 0; c < R::NCH; ++c) {
        tma_load3(sK + c * R::CHUNK, &tk, full_kv, c * R::CW, k0, bkv);
        tma_load3(sV + c * R::CHUNK, &tv, full_kv, c * R::CW, k0, bkv);
      }
      const int BH = gridDim.x * p.G;
      for (int it = 0; it < items; ++it) {
        const int s = it % kStages, parity = ((it / kStages) & 1) ^ 1;
        const int bh = bkv * p.G + it / nq;
        const int q0 = (qt_lo + it % nq) * kCols;
        mbar_wait(empty + s, parity);
        mbar_expect_tx(full + s, 2 * C::BYTES + L::kStats);
        for (int c = 0; c < C::NCH; ++c) {
          tma_load3(sQ + s * C::BYTES + c * C::CHUNK, &tq, full + s,
                    c * C::CW, q0, bh);
          tma_load3(sG + s * C::BYTES + c * C::CHUNK, &tg, full + s,
                    c * C::CW, q0, bh);
        }
        float* st = sS + s * 2 * kCols;
        tma_load2(st, &ts, full + s, q0, bh);
        tma_load2(st + kCols, &ts, full + s, q0, BH + bh);
      }
    }
  } else {
    // ---------------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, ct = tid % 128;
    const int lane = ct % 32, g = lane >> 2, t = lane & 3;
    const int kb = k0 + wg * 64;                 // this warpgroup's keys
    const int kb1 = min(kb + 64, p.Sk);
    const int kr = kb + (ct / 32) * 16 + g;      // keys kr and kr + 8
    const int kpos[2] = {kr, kr + 8};

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dk[x] = dv[x] = 0.f;
    if (items > 0) {
      const uint32_t k_at = smem_addr(sK) + wg * 64 * R::PITCH;
      const uint32_t v_at = smem_addr(sV) + wg * 64 * R::PITCH;
      const uint32_t q_at = smem_addr(sQ), g_at = smem_addr(sG);
      mbar_wait(full_kv, 0);
      for (int it = 0; it < items; ++it) {
        const int st = it % kStages, par = (it / kStages) & 1;
        const int q0 = (qt_lo + it % nq) * kCols;
        mbar_wait(full + st, par);
        if (any_allowed(p, q0, min(q0 + kCols, p.Sq), kb, kb1)) {
          float s[32], dp[32];
          uint32_t pf[16], df[16];
          // S^T = K Q^T and dP^T = V dO^T
          wg_fence();
          ss_issue<HD>(s, k_at, q_at + st * C::BYTES);
          ss_issue<HD>(dp, v_at, g_at + st * C::BYTES);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            keep(s[x]);
            keep(dp[x]);
          }
          const float* lse2 = sS + st * 2 * kCols;
          if (tile_full(p, q0, q0 + kCols, kb, kb + 64))
            p_ds_by_cols<CAP, false>(p, s, dp, lse2, lse2 + kCols, q0, kpos,
                                     t);
          else
            p_ds_by_cols<CAP, true>(p, s, dp, lse2, lse2 + kCols, q0, kpos,
                                    t);
          to_fragments(s, pf);
          to_fragments(dp, df);
          // dV += P^T dO and dK += dS^T Q
          wg_fence();
          rs_issue<HD>(dv, pf, g_at + st * C::BYTES);
          rs_issue<HD>(dk, df, q_at + st * C::BYTES);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int x = 0; x < HD / 2; ++x) {
            keep(dk[x]);
            keep(dv[x]);
          }
#pragma unroll
          for (int x = 0; x < 16; ++x) {
            keep(pf[x]);
            keep(df[x]);
          }
        }
        mbar_arrive(empty + st);
      }
    }
    const size_t krow0 = static_cast<size_t>(bkv) * p.Sk;
    store_acc<HD>(static_cast<bf16*>(p.dk) + krow0 * HD, dk, kr, p.Sk,
                   p.scale, t);
    store_acc<HD>(static_cast<bf16*>(p.dv) + krow0 * HD, dv, kr, p.Sk, 1.f,
                   t);
  }
}

// ------------------------------------------------------------------ launch
template <int HD>
cudaError_t launch_f32(const Params& p, int BH, int BKV, cudaStream_t stream) {
  constexpr int LD = Cfg<HD>::LD;
  constexpr size_t smem_dq =
      sizeof(float) * ((2 * kAQ + 2 * kAK) * LD + kAQ * (kAK + 1));
  constexpr size_t smem_dkv =
      sizeof(float) * ((2 * kBK + 2 * kBQ) * LD + 2 * kBQ * (kBK + 1) +
                       2 * kBQ);
  static bool opted_dq = false, opted_dkv = false;
  cudaError_t e = opt_in(attn_bwd_dq_kernel<HD>, smem_dq, opted_dq);
  if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_kernel<HD>, smem_dkv,
                                   opted_dkv);
  if (e != cudaSuccess) return e;
  if (p.Sq > 0) {
    attn_bwd_dq_kernel<HD>
        <<<dim3((p.Sq + kAQ - 1) / kAQ, BH), kThreads, smem_dq, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (p.Sk > 0)
    attn_bwd_dkv_kernel<HD>
        <<<dim3((p.Sk + kBK - 1) / kBK, BKV), kThreads, smem_dkv, stream>>>(
            p);
  return cudaGetLastError();
}

template <int HD, bool CAP>
cudaError_t launch_bf16(const Params& p, int BH, int BKV,
                        cudaStream_t stream) {
  constexpr size_t smem = WLayout<HD>::SMEM;
  static bool opted_dq = false, opted_dkv = false;
  cudaError_t e = opt_in(attn_bwd_dq_wgmma_kernel<HD, CAP>, smem, opted_dq);
  if (e == cudaSuccess)
    e = opt_in(attn_bwd_dkv_wgmma_kernel<HD, CAP>, smem, opted_dkv);
  if (e != cudaSuccess) return e;
  // maps a side with no rows leaves zeroed: no launch reads them
  CUtensorMap q_own{}, g_own{}, k_own{}, v_own{};    // kRows-row boxes
  CUtensorMap q_col{}, g_col{}, k_col{}, v_col{};    // kCols-row boxes
  CUtensorMap stats{};
  if (p.Sq > 0 &&
      (!tensor_map<HD, kRows>(&q_own, p.q, p.Sq, BH) ||
       !tensor_map<HD, kRows>(&g_own, p.g, p.Sq, BH) ||
       !tensor_map<HD, kCols>(&q_col, p.q, p.Sq, BH) ||
       !tensor_map<HD, kCols>(&g_col, p.g, p.Sq, BH) ||
       !tensor_map_f32<kCols>(&stats, p.stats, p.Sq_pad, 2 * BH)))
    return cudaErrorInvalidValue;
  if (p.Sk > 0 &&
      (!tensor_map<HD, kRows>(&k_own, p.k, p.Sk, BKV) ||
       !tensor_map<HD, kRows>(&v_own, p.v, p.Sk, BKV) ||
       !tensor_map<HD, kCols>(&k_col, p.k, p.Sk, BKV) ||
       !tensor_map<HD, kCols>(&v_col, p.v, p.Sk, BKV)))
    return cudaErrorInvalidValue;
  if (p.Sq > 0) {
    attn_bwd_dq_wgmma_kernel<HD, CAP>
        <<<dim3(BH, (p.Sq + kRows - 1) / kRows), kWThreads, smem, stream>>>(
            q_own, g_own, k_col, v_col, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (p.Sk > 0)
    attn_bwd_dkv_wgmma_kernel<HD, CAP>
        <<<dim3(BKV, (p.Sk + kRows - 1) / kRows), kWThreads, smem, stream>>>(
            k_own, v_own, q_col, g_col, stats, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Params& p, int BH, int BKV, bool bf16_in,
                   cudaStream_t stream) {
  if (!bf16_in) return launch_f32<HD>(p, BH, BKV, stream);
  return p.softcap > 0.f ? launch_bf16<HD, true>(p, BH, BKV, stream)
                         : launch_bf16<HD, false>(p, BH, BKV, stream);
}

}  // namespace

// C entry point (loaded with ctypes). q/o/g/dq (BH, Sq, hd) and k/v/dk/dv
// (BKV, Sk, hd) are device pointers of contiguous, 16-byte aligned tensors,
// all bf16 when `bf16` is 1 and all fp32 when it is 0; hd must be 32, 64 or
// 128; `stream` is a cudaStream_t. Launches the dq kernel, then the dkv
// kernel. bf16: `lse` is the forward kernel's (BH, Sq) logsumexp (required
// when Sq > 0) and `stats` a (2, BH, ceil(Sq / 128) * 128) fp32 scratch
// the first launch writes (each row's logsumexp in log2 units and D) and
// the second reads by TMA. fp32: `lse` is not read and `stats` is a
// (2, BH, Sq) scratch of the rows' logsumexp and D, which the first launch
// makes. Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape or pointer the kernels do not take. Sq =
// 0 launches the dkv kernel alone (zeros), Sk = 0 the dq kernel alone
// (zeros).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, const float* lse,
    float* stats, int BH, int BKV, int Sq, int Sk, int hd, int bf16,
    int causal, int window, float scale, float softcap, void* stream) {
  if (BH < 0 || BKV < 1 || BH % BKV != 0 || Sq < 0 || Sk < 0 ||
      BH > 65535 || BKV > 65535 || (bf16 && Sq > 0 && lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || (Sq == 0 && Sk == 0)) return 0;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.Sq = Sq; p.Sk = Sk; p.G = BH / BKV;
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap;
  p.scale_log2 = scale * kLog2e;
  p.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap * kLog2e;
  if (bf16) {
    p.lse_in = lse;
    p.stats = stats;
    p.Sq_pad = (Sq + kRows - 1) / kRows * kRows;
  } else {
    p.lse = stats;
    p.delta = stats + static_cast<size_t>(BH) * Sq;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch<32>(p, BH, BKV, bf16 != 0, s); break;
    case 64: e = launch<64>(p, BH, BKV, bf16 != 0, s); break;
    case 128: e = launch<128>(p, BH, BKV, bf16 != 0, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
