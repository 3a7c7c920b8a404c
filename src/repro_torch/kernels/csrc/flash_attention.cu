// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (mma.sync), fp32 exactly on the FMA units.
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
// The output is in q's dtype.
//
// Bound on an H100: operations. At qwen3-8b's prefill (Sq = Sk = 4096, 32
// heads, hd 128, causal) a call does 4 * hd flops for each of the 268M
// allowed (query, key) pairs of each head, 137 GFLOP, 0.14 ms at the bf16
// tensor-core peak, against 84 MB moved, 0.025 ms at 3.35 TB/s. A decode
// step (Sq = 1) is bound by the bytes of k and v instead.
//
// Design, bf16 (flash_bf16_kernel): a block of four warps owns 64 query
// rows of one head, 16 rows a warp, and walks the allowed key tiles of 64
// keys. q is loaded once into registers as mma.sync A fragments; k and v
// tiles are double-buffered in shared memory with cp.async, the next tile
// in flight while this one is used, rows padded by 16 bytes so the
// ldmatrix reads hit distinct banks. S = Q K^T goes through
// mma.sync.m16n8k16 (bf16 in, fp32 out), the masked online softmax runs in
// registers (row max and sum over the four lanes of a quad), and P, rounded
// to bf16, is reused from the S accumulators as the A operand of O += P V,
// with v read through ldmatrix.trans. wgmma and TMA are later work.
//
// Design, fp32 (flash_f32_kernel): a block of 256 threads owns 64 query
// rows and walks key tiles of 32; q, k, v and P tiles sit in shared memory
// with odd row strides, each thread holds a 4 x 2 tile of S and a 4 x hd/16
// tile of O, and every product is an fp32 FMA: no tensor cores, no TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;                   // a masked score
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, G;
  int causal, window;
  float scale, softcap;
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

// Masked score, online-softmax weight: 0 for a masked score.
__device__ __forceinline__ float weight(float s, float m) {
  return s == kNeg ? 0.f : expf(s - m);
}

__device__ __forceinline__ float cap(const Params& p, float s) {
  s *= p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

// ---------------------------------------------------------------- bf16 path
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !pred.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kBQ = 64;                          // query rows per block
constexpr int kBK = 64;                          // keys per tile (bf16)
constexpr int kWarps = 4;

// Rows [row0, row0 + ROWS) of a (nrows, HD) bf16 matrix into shared memory
// with row stride LD; rows past nrows are zero-filled.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int row0,
                                          int nrows, int tid) {
  constexpr int kChunks = HD / 8;                // 16-byte chunks per row
  for (int c = tid; c < ROWS * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(s + r * LD + col,
               g + static_cast<size_t>(ok ? row0 + r : 0) * HD + col, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_bf16_kernel(Params p) {
  constexpr int LD = HD + 8;                     // padded row, bf16 elements
  constexpr int KD = HD / 16;                    // k16 steps over hd
  constexpr int NS = kBK / 8;                    // n8 tiles of S
  constexpr int NO = HD / 8;                     // n8 tiles of O
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sK = sQ + kBQ * LD;             // 2 stages
  __nv_bfloat16* sV = sK + 2 * kBK * LD;         // 2 stages

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int q1 = min(q0 + kBQ, p.Sq);
  const auto* Q = static_cast<const __nv_bfloat16*>(p.q) +
                  static_cast<size_t>(bh) * p.Sq * HD;
  const auto* K = static_cast<const __nv_bfloat16*>(p.k) +
                  static_cast<size_t>(bh / p.G) * p.Sk * HD;
  const auto* V = static_cast<const __nv_bfloat16*>(p.v) +
                  static_cast<size_t>(bh / p.G) * p.Sk * HD;
  auto* O = static_cast<__nv_bfloat16*>(p.o) +
            static_cast<size_t>(bh) * p.Sq * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int off = p.Sk - p.Sq;
  const int r0 = q0 + warp * 16 + g;             // rows r0 and r0 + 8
  const int qpos[2] = {r0 + off, r0 + 8 + off};

  int kt_lo, kt_hi;
  key_tiles(p, q0, q1, kBK, kt_lo, kt_hi);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  uint32_t qf[KD][4];                            // q as A fragments
  if (kt_lo < kt_hi) {
    load_tile<HD, LD, kBQ>(sQ, Q, q0, p.Sq, tid);
    load_tile<HD, LD, kBK>(sK, K, kt_lo * kBK, p.Sk, tid);
    load_tile<HD, LD, kBK>(sV, V, kt_lo * kBK, p.Sk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8);
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_tile<HD, LD, kBK>(sK + (stage ^ 1) * kBK * LD, K, (kt + 1) * kBK,
                             p.Sk, tid);
      load_tile<HD, LD, kBK>(sV + (stage ^ 1) * kBK * LD, V, (kt + 1) * kBK,
                             p.Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // this tile has landed
    __syncthreads();
    const __nv_bfloat16* k_s = sK + stage * kBK * LD;
    const __nv_bfloat16* v_s = sV + stage * kBK * LD;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = kt * kBK;
    const bool full = tile_full(p, q0, q1, k0, k0 + kBK);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap(p, s[n][e]);
        if (!full && !allowed(p, k0 + n * 8 + 2 * tq + (e & 1), qpos[e >> 1]))
          x = kNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float alpha = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = weight(s[n][e], m[e >> 1]);
        l[e >> 1] += s[n][e];
      }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                             // stage free for reuse
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int r = r0 + 8 * i;
    if (r < p.Sq) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(O + static_cast<size_t>(r) * HD + n * 8 +
                                     2 * tq) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- fp32 path
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

// Opts the kernel into `smem` bytes of dynamic shared memory once, then
// launches one block per (64 query rows, head).
template <typename Kernel>
cudaError_t run(Kernel kernel, int threads, size_t smem, bool& opted,
                const Params& p, int BH, cudaStream_t stream) {
  if (!opted && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  opted = true;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Params& p, int BH, bool bf16, cudaStream_t stream) {
  if (bf16) {
    static bool opted = false;
    const size_t smem = sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * (HD + 8);
    return run(flash_bf16_kernel<HD>, kWarps * 32, smem, opted, p, BH,
               stream);
  }
  static bool opted = false;
  const size_t smem = sizeof(float) * ((kBQ + kBK32) * (HD + 1) +
                                       kBK32 * HD + kBQ * (kBK32 + 1));
  return run(flash_f32_kernel<HD>, kT32 * kT32, smem, opted, p, BH, stream);
}

}  // namespace

// C entry point (loaded with ctypes). q/k/v/o are device pointers of
// contiguous, 16-byte aligned tensors, all bf16 (`bf16` = 1) or all fp32;
// hd must be 32, 64 or 128; `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int BH,
                                       int BKV, int Sq, int Sk, int hd,
                                       int bf16, int causal, int window,
                                       float scale, float softcap,
                                       void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BH < 0 || BKV < 1 || BH % BKV != 0 || BH > 65535 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Sq, Sk, BH / BKV, causal, window, scale,
                 softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch<32>(p, BH, bf16 != 0, s); break;
    case 64: e = launch<64>(p, BH, bf16 != 0, s); break;
    case 128: e = launch<128>(p, BH, bf16 != 0, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
