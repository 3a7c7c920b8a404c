// Flash attention backward for Hopper (sm_90a): bf16 on the tensor cores
// (mma.sync, fp32 accumulate), fp32 exactly on the FMA units.
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
// These kernels recompute QK^T three times and g V^T twice: 8 products,
// 138 GFLOP. bf16 runs them on mma.sync (a quarter or less of the
// card's wgmma rate); wgmma, TMA and a logsumexp saved by the forward
// are later work. fp32 runs them on the FMA units (67 TFLOP/s: 2.05 ms at
// this shape), exactly, with no TF32.
//
// Design: two launches, no atomics, repeatable bit for bit. Both dtypes
// share it; the bf16 kernels (at the end) give a warp 16 rows of each
// product on the tensor cores, the fp32 ones a thread a register tile.
// - dq kernel: a block owns 64 query rows of one head (fp32: 256 threads,
//   each 4 rows x 2 keys of a score tile, 4 rows x hd/16 columns of dQ).
//   It loads its q and g rows once and takes D from g and o. A first pass
//   over the key tiles that hold an allowed key (online max and sum) gives
//   each row's logsumexp; the row statistics go to a scratch (2, BH, Sq)
//   for the second kernel. A second pass recomputes S and dP a tile of
//   keys at a time (fp32: 32 keys, dS through shared memory; bf16: 64, dS
//   rounded to bf16 in registers) and adds dS K to the dQ registers.
// - dkv kernel: a block owns 64 keys of one k/v head, loads its k
//   and v rows once, and walks the G query heads of that k/v head and,
//   in each, the tiles of 32 query rows that may attend to one of its
//   keys (no other tile is read: a sliding window costs O(S window)).
//   Each tile recomputes S and dP (bf16: transposed, the warp's 16 keys
//   by the tile's rows), forms P and dS (fp32: in shared memory; bf16:
//   rounded to bf16 in registers) and adds P^T g and dS^T q to the dV
//   and dK registers.
// - fp32: the products that reduce over hd read 16-byte vectors along hd
//   (rows padded to hd + 4 floats, so 8 rows' vectors fill the 32 banks);
//   the ones that reduce over keys or rows read vectors of the output
//   columns. S is summed over hd in the same order in both kernels, so
//   both see the same P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  float* lse;                                    // (BH, Sq)
  float* delta;                                  // (BH, Sq)
  int Sq, Sk, G;
  int causal, window;
  float scale, softcap;
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

// ------------------------------------------- bf16: tensor cores (mma.sync)
// The same two kernels for bf16 inputs, each product on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). A warp owns 16 rows (queries in
// the dq kernel, keys in the dkv kernel); tiles are staged as bf16 by
// cp.async into rows padded to hd + 8 (ldmatrix reads 8 rows without a
// bank conflict). S and dP stay in fp32 accumulators; P and dS are
// rounded to bf16 as the A operand of the next product, straight from
// the accumulators' registers.
using bf16 = __nv_bfloat16;
constexpr int kMThreads = 128;                   // 4 warps
constexpr int kMQ = 64, kMK = 64;                // dq kernel: rows, keys
constexpr int kNK = 64, kNQ = 32;                // dkv kernel: keys, rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Two n-tiles of accumulators (16 x 16) as the A operand of a product
// over those 16 columns, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [0, nrows) of a (rows, HD) bf16 tensor into shared rows of stride
// HD + 8 by cp.async; rows from `valid` on are zeros.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int valid, int nrows) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = threadIdx.x; c < nrows * CH; c += kMThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + col,
               src + static_cast<size_t>(ok ? r : 0) * HD + col, ok);
  }
}

// acc[n] (NT n-tiles of 8 columns) = A (the warp's 16 rows of a, from row
// a_row0) times B^T (b's rows as the columns), both (rows, HD) in shared
// memory: S = Q K^T, dP = g V^T and their transposes.
template <int HD, int NT>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NT][4],
                                             const bf16* a, int a_row0,
                                             const bf16* b) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (a_row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// out[HD / 8][4] += A (16 x 16 rows of the k-step, registers) times the
// 16 rows [row0, row0 + 16) of b (rows, HD) in shared memory.
template <int HD>
__device__ __forceinline__ void acc_rows(float (&out)[HD / 8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* b, int row0) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    uint32_t fb[4];
    ldsm_x4_trans(fb, b + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          c * 16 + (lane >> 4) * 8);
    mma_bf16(out[2 * c], a, fb[0], fb[1]);
    mma_bf16(out[2 * c + 1], a, fb[2], fb[3]);
  }
}

// The warp's 16 rows (from row0) of accumulators times `mul` into the
// (rows, HD) bf16 tensor out; rows from `valid` on are not written.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* out,
                                          const float (&acc)[HD / 8][4],
                                          int row0, int valid, float mul) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * HD + n * 8 +
                                   2 * t) =
          pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMThreads, 2)
    attn_bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = HD + 8, NT = kMK / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* const sQ = reinterpret_cast<bf16*>(smem_u4);   // kMQ x LD
  bf16* const sG = sQ + kMQ * LD;                      // kMQ x LD
  bf16* const sK = sG + kMQ * LD;                      // kMK x LD
  bf16* const sV = sK + kMK * LD;                      // kMK x LD
  float* const sD = reinterpret_cast<float*>(sV + kMK * LD);   // kMQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMQ;   // long rows first
  const int nq = min(kMQ, p.Sq - q0);
  const int off = p.Sk - p.Sq;
  const int r0 = warp * 16;                            // the warp's rows
  const size_t row0 = static_cast<size_t>(bh) * p.Sq + q0;
  const bf16* O = static_cast<const bf16*>(p.o) + row0 * HD;
  const bf16* K = static_cast<const bf16*>(p.k) +
                  static_cast<size_t>(bh / p.G) * p.Sk * HD;
  const bf16* V = static_cast<const bf16*>(p.v) +
                  static_cast<size_t>(bh / p.G) * p.Sk * HD;

  stage_rows<HD>(sQ, static_cast<const bf16*>(p.q) + row0 * HD, nq, kMQ);
  stage_rows<HD>(sG, static_cast<const bf16*>(p.g) + row0 * HD, nq, kMQ);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // D = rowsum(g o) of the warp's rows, a warp a row
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    float acc = 0.f;
    if (r < nq)
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(__bfloat162float(sG[r * LD + d]),
                   __bfloat162float(O[static_cast<size_t>(r) * HD + d]), acc);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) acc += __shfl_xor_sync(kFull, acc, w);
    if (lane == 0) sD[r] = acc;
  }
  __syncwarp();
  const float dl[2] = {sD[r0 + g], sD[r0 + g + 8]};
  const int qpos[2] = {q0 + r0 + g + off, q0 + r0 + g + 8 + off};

  int lo, hi;
  key_tiles(p, q0, q0 + nq, kMK, lo, hi);
  auto stage_kv = [&](int k0, bool with_v) {    // key tile k0 (and its v)
    __syncthreads();                             // the last tile is read
    stage_rows<HD>(sK, K + static_cast<size_t>(k0) * HD, p.Sk - k0, kMK);
    if (with_v)
      stage_rows<HD>(sV, V + static_cast<size_t>(k0) * HD, p.Sk - k0, kMK);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };

  // pass 1: each row's logsumexp, online (a row's 64 keys of a tile are
  // spread over the 4 threads of a quad)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kMK;
    stage_kv(k0, false);
    float s[NT][4];
    rows_by_rows<HD, NT>(s, sQ, r0, sK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float fac;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = allowed(p, kpos, qpos[e >> 1]) ? score(p, s[n][e], fac)
                                                 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      const float mu = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        sum += expf(s[n][2 * i] - mu) + expf(s[n][2 * i + 1] - mu);
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[i] = l[i] * expf(m[i] - mu) + sum;
      m[i] = mn;
    }
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;   // 0: no allowed key
    const int r = r0 + g + 8 * i;
    if (t == 0 && r < nq) {
      p.lse[row0 + r] = lse[i];
      p.delta[row0 + r] = dl[i];
    }
  }

  // pass 2: dS a tile at a time, dQ += dS K
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kMK;
    stage_kv(k0, true);
    float s[NT][4], dp[NT][4];
    rows_by_rows<HD, NT>(s, sQ, r0, sK);
    rows_by_rows<HD, NT>(dp, sG, r0, sV);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (allowed(p, kpos, qpos[i])) {
          float fac;
          const float pr = expf(score(p, s[n][e], fac) - lse[i]);
          ds = pr * (dp[n][e] - dl[i]) * fac;
        }
        s[n][e] = ds;
      }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t a[4];
      to_a(a, s[2 * np], s[2 * np + 1]);
      acc_rows<HD>(dq, a, sK, np * 16);
    }
  }
  store_acc<HD>(static_cast<bf16*>(p.dq) + row0 * HD, dq, r0, nq, p.scale);
}

template <int HD>
__global__ void __launch_bounds__(kMThreads, 2)
    attn_bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = HD + 8, NT = kNQ / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* const sK = reinterpret_cast<bf16*>(smem_u4);   // kNK x LD
  bf16* const sV = sK + kNK * LD;                      // kNK x LD
  bf16* const sQ = sV + kNK * LD;                      // kNQ x LD
  bf16* const sG = sQ + kNQ * LD;                      // kNQ x LD
  float* const sL = reinterpret_cast<float*>(sG + kNQ * LD);   // kNQ
  float* const sDl = sL + kNQ;                                 // kNQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * kNK;
  const int nk = min(kNK, p.Sk - k0);
  const int off = p.Sk - p.Sq;
  const int kr0 = warp * 16;                           // the warp's keys
  const int kpos[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};
  const size_t krow0 = static_cast<size_t>(bkv) * p.Sk + k0;
  stage_rows<HD>(sK, static_cast<const bf16*>(p.k) + krow0 * HD, nk, kNK);
  stage_rows<HD>(sV, static_cast<const bf16*>(p.v) + krow0 * HD, nk, kNK);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int lo, hi;
  query_tiles(p, k0, k0 + nk, kNQ, lo, hi);
  cp_async_commit();                             // k and v
  for (int h = 0; h < p.G; ++h) {
    const int bh = bkv * p.G + h;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kNQ;
      const int nq = min(kNQ, p.Sq - q0);
      const size_t row0 = static_cast<size_t>(bh) * p.Sq + q0;
      __syncthreads();                           // the last tile is read
      stage_rows<HD>(sQ, static_cast<const bf16*>(p.q) + row0 * HD, nq, kNQ);
      stage_rows<HD>(sG, static_cast<const bf16*>(p.g) + row0 * HD, nq, kNQ);
      cp_async_commit();
      if (threadIdx.x < kNQ) {
        const bool ok = static_cast<int>(threadIdx.x) < nq;
        sL[threadIdx.x] = ok ? p.lse[row0 + threadIdx.x] : 0.f;
        sDl[threadIdx.x] = ok ? p.delta[row0 + threadIdx.x] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // S^T and dP^T: the warp's 16 keys by the tile's kNQ rows
      float s[NT][4], dp[NT][4];
      rows_by_rows<HD, NT>(s, sK, kr0, sQ);
      rows_by_rows<HD, NT>(dp, sV, kr0, sG);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * t + (e & 1);   // the query row
          float pr = 0.f, ds = 0.f;
          if (r < nq && allowed(p, kpos[e >> 1], q0 + r + off)) {
            float fac;
            pr = expf(score(p, s[n][e], fac) - sL[r]);
            ds = pr * (dp[n][e] - sDl[r]) * fac;
          }
          s[n][e] = pr;
          dp[n][e] = ds;
        }
      // dV += P^T g, dK += dS^T q, 16 rows a step
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t a[4];
        to_a(a, s[2 * np], s[2 * np + 1]);
        acc_rows<HD>(dv, a, sG, np * 16);
        to_a(a, dp[2 * np], dp[2 * np + 1]);
        acc_rows<HD>(dk, a, sQ, np * 16);
      }
    }
  }
  cp_async_wait_all();                           // k and v, if no tile ran
  store_acc<HD>(static_cast<bf16*>(p.dk) + krow0 * HD, dk, kr0, nk, p.scale);
  store_acc<HD>(static_cast<bf16*>(p.dv) + krow0 * HD, dv, kr0, nk, 1.f);
}

// ------------------------------------------------------------------ launch
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))
             : cudaSuccess;
}

template <int HD>
cudaError_t launch_f32(const Params& p, int BH, int BKV, cudaStream_t stream) {
  constexpr int LD = Cfg<HD>::LD;
  constexpr size_t smem_dq =
      sizeof(float) * ((2 * kAQ + 2 * kAK) * LD + kAQ * (kAK + 1));
  constexpr size_t smem_dkv =
      sizeof(float) * ((2 * kBK + 2 * kBQ) * LD + 2 * kBQ * (kBK + 1) +
                       2 * kBQ);
  static bool opted = false;
  if (!opted) {
    cudaError_t e = opt_in(attn_bwd_dq_kernel<HD>, smem_dq);
    if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_kernel<HD>, smem_dkv);
    if (e != cudaSuccess) return e;
    opted = true;
  }
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

template <int HD>
cudaError_t launch_bf16(const Params& p, int BH, int BKV,
                        cudaStream_t stream) {
  constexpr int LD = HD + 8;
  constexpr size_t smem_dq =
      sizeof(bf16) * (2 * kMQ + 2 * kMK) * LD + sizeof(float) * kMQ;
  constexpr size_t smem_dkv =
      sizeof(bf16) * (2 * kNK + 2 * kNQ) * LD + sizeof(float) * 2 * kNQ;
  static bool opted = false;
  if (!opted) {
    cudaError_t e = opt_in(attn_bwd_dq_mma_kernel<HD>, smem_dq);
    if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_mma_kernel<HD>, smem_dkv);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  if (p.Sq > 0) {
    attn_bwd_dq_mma_kernel<HD>
        <<<dim3((p.Sq + kMQ - 1) / kMQ, BH), kMThreads, smem_dq, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (p.Sk > 0)
    attn_bwd_dkv_mma_kernel<HD>
        <<<dim3((p.Sk + kNK - 1) / kNK, BKV), kMThreads, smem_dkv, stream>>>(
            p);
  return cudaGetLastError();
}

cudaError_t launch(const Params& p, int BH, int BKV, int hd, bool bf16_in,
                   cudaStream_t stream) {
  switch (hd) {
    case 32: return bf16_in ? launch_bf16<32>(p, BH, BKV, stream)
                            : launch_f32<32>(p, BH, BKV, stream);
    case 64: return bf16_in ? launch_bf16<64>(p, BH, BKV, stream)
                            : launch_f32<64>(p, BH, BKV, stream);
    case 128: return bf16_in ? launch_bf16<128>(p, BH, BKV, stream)
                             : launch_f32<128>(p, BH, BKV, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (loaded with ctypes). q/o/g/dq (BH, Sq, hd) and k/v/dk/dv
// (BKV, Sk, hd) are device pointers of contiguous, 16-byte aligned tensors,
// all bf16 when `bf16` is 1 and all fp32 when it is 0; lse and delta are
// (BH, Sq) fp32 scratch the first launch writes and the second reads; hd
// must be 32, 64 or 128; `stream` is a cudaStream_t. Launches the dq
// kernel, then the dkv kernel. Returns cudaGetLastError() after
// the launches (0 = launched), or cudaErrorInvalidValue for a shape the
// kernels do not take. Sq = 0 launches the dkv kernel alone (zeros), Sk
// = 0 the dq kernel alone (zeros).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, float* lse, float* delta,
    int BH, int BKV, int Sq, int Sk, int hd, int bf16, int causal,
    int window, float scale, float softcap, void* stream) {
  if (BH < 0 || BKV < 1 || BH % BKV != 0 || Sq < 0 || Sk < 0 ||
      BH > 65535 || BKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || (Sq == 0 && Sk == 0)) return 0;
  const Params p{q, k, v, o, g, dq, dk, dv, lse, delta, Sq, Sk, BH / BKV,
                 causal, window, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(p, BH, BKV, hd, bf16 != 0, s));
}
