// Fused TreeCNN encoder backward for Hopper (sm_90a), fp32.
//
// Replaces the backward of the Pallas TPU kernel
// repro/kernels/tree_conv.py::tree_cnn_fused: `_fused_bwd` (:202), the
// custom VJP rule of the kernel at :86, which rematerialises the forward in
// jnp and pulls the cotangent through it. Given g (B, H) = d loss / d out,
// it recomputes each tree's three layers
//   a_l = leaky_relu_0.01(z_l),  z_l = h W_r + h[left] W_l + h[right] W_rt + b,
//   h_l = a_l * mask (l = 1, 2),  h3 = a3 * mask + h2,
//   out = max over masked nodes of h3 (all-masked -> 0),
// and pulls g back through the max-pool (split evenly among tied maxima;
// an all-masked tree passes nothing back), the residual, the three layers
// (leaky_relu's gradient is 0.01 where z <= 0) and the children's gathers
// (a scatter-add back to the nodes they read; an index outside [0, N) reads
// a zero row and gets nothing). Outputs: the 12 weight gradients, summed
// over every tree and node, as one flat vector in the order conv1..conv3 x
// (wr, wl, wrt, b); optionally gfeat (B, N, F) = g_h0 * mask and gmask
// (B, N) = sum_f g_h0 feat + sum_l sum_c g_{h_l} a_l.
//
// Bound on an H100: at the actor's PPO shape (B = 24 trees, N = 48, F = 26,
// H = 96) the recompute, the input-gradient and the weight-gradient products
// are ~0.3 GFLOP of fp32 FMAs, ~4.3 us at 67 TFLOP/s; the bytes (inputs,
// weights, gradients, ~0.6 MB, plus 2 x 24 x 251 KB of per-tree partials)
// take ~3.6 us at 3.35 TB/s. Every product is a few hundred FMAs deep and
// its operands come from shared memory, so what bounds one tree is the
// shared-memory load rate and the latency of a chain of dependent phases;
// one SM a tree would leave 100 of 132 SMs idle.
//
// Design: a thread-block cluster of C = 4 blocks per tree (BWD_CLUSTER; 8
// builds too and was slower), 256 threads a block, two blocks an SM at the
// PPO shape, so the card holds 62 clusters of 4 at once and 32 trees run in
// one wave (30 clusters of 8 would not). Block r owns the output channels c
// in [r Hc, (r + 1) Hc), Hc = ceil(H / C) (the last slices may be short or
// empty), and the same slice j of each layer's input width for the input
// gradient (ceil(F / C) of F for layer 1). Every block keeps the whole
// tree's h0, a1 and a2 in shared memory:
//   - recompute: each block computes its channel slice of a1, a2, a3 from
//     W[:, c-slice] and all-gathers a1 and a2 through distributed shared
//     memory (DSMEM) after a cluster barrier;
//   - the pool's backward, each layer's g_z = g_h * mask * leaky_relu'(z)
//     and the weight gradients gW[:, c-slice] = h_in^T g_z[:, c-slice] need
//     only the whole h_in, which the block holds, and its own g_z slice;
//   - the input gradient: one DSMEM all-gather of g_z (N x H), then
//     g_h_in[:, j-slice] = g_z W_r[j-slice, :]^T plus the left and right
//     products scattered to the children over each node's parent list, in
//     ascending parent order. For layers 3 and 2 the j-slice is the c-slice
//     of the layer below, so it feeds that layer's g_z with no exchange.
// That is one cluster barrier and one all-gather a layer, plus the
// recompute's two; g_z3 and g_z2 pass through a2's buffer, guarded by split
// cluster barriers, so a block needs 103 KB at the PPO shape. Each
// product keeps a register tile a thread (3 nodes x 2 channels, 4 rows x 3
// channels, 3 nodes x 2 rows), so one shared-memory load feeds several
// FMAs. Each phase's weight slices (W[:, c-slice] for the recompute,
// W[j-slice, :] for the input gradient, three matrices each) are copied
// into one shared-memory slot with cp.async as soon as the previous phase
// is done with it, under the phases between (a second slot measured no
// faster and would cost the second block an SM). gmask is each block's partial over
// its channels, summed across the cluster in rank order through DSMEM.
// Each block writes its channel slice of the tree's weight-gradient
// partial; a second launch sums the trees in tree order. No float atomics
// anywhere, so the result repeats bit for bit. Plain fp32 FMAs on the CUDA
// cores, no tensor cores, no TF32.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNodes = 64;
constexpr int kMaxWidth = 128;                   // F and H
constexpr size_t kMaxSmem = 232448;              // a block's opt-in limit
// Blocks a tree (4 or 8) and threads a block, chosen by measurement on an
// H100 (PERF.md); tools/bwd_bench.py builds copies with other values.
#define BWD_CLUSTER 4
#define BWD_THREADS 256
constexpr int kCluster = BWD_CLUSTER;
constexpr int kThreads = BWD_THREADS;
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// Row stride in floats: a multiple of 4 (float4 loads) that is not a
// multiple of 32, so float4 rows a quarter-warp reads start in different
// banks.
__host__ __device__ constexpr int row_ld(int d) {
  return (pad4(d) % 32 == 0) ? pad4(d) + 4 : pad4(d);
}

struct Layer {
  const float* wr;   // (din, H), used as x @ W
  const float* wl;
  const float* wt;
  const float* b;    // (H,)
};

// Shared-memory layout of one block, offsets in floats (each a multiple of
// 4, so every buffer is 16-byte aligned).
struct Plan {
  int Hc, Fc, Jc, ldf, ldh;
  int h0, A, B, S2, S3, G, XS, ring, gm, msk, ints, total;
};

__host__ __device__ inline Plan make_plan(int N, int F, int H) {
  Plan p;
  p.Hc = cdiv(H, kCluster);
  p.Fc = cdiv(F, kCluster);
  p.Jc = imax(p.Hc, p.Fc);
  p.ldf = row_ld(F);
  p.ldh = row_ld(H);
  int at = 0;
  p.h0 = at;   at += pad4((N + 1) * p.ldf);     // feat * mask, row N zero
  p.A = at;    at += pad4((N + 1) * p.ldh);     // a1, later g_z1
  p.B = at;    at += pad4((N + 1) * p.ldh);     // a2, later g_z3, g_z2
  p.S2 = at;   at += pad4(N * p.Hc);            // a2, own channels
  p.S3 = at;   at += pad4(N * p.Hc);            // a3, then g_z3, own
  p.G = at;    at += pad4(N * p.Jc);            // g_h, own j-slice
  p.XS = at;   at += pad4(3 * N * p.Jc);        // scaled g_z, or products
  p.ring = at;                                  // staged weight slices
  at += pad4(imax(3 * imax(F, H) * p.Hc, 3 * p.Jc * p.ldh));
  p.gm = at;   at += pad4(N);                   // d out / d mask partial
  p.msk = at;  at += pad4(N + 1);               // msk[N] = 0
  p.ints = at; at += pad4(8 * N + 2);           // children, parent lists
  p.total = at;
  return p;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : 0.01f * v; }

// Split cluster barrier: arrive (release) now, wait (acquire) later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Tree {
  int N;
  const int* lch;      // child index, N where outside [0, N)
  const int* rch;
  const float* msk;    // N + 1 entries, msk[N] = 0
  const int* poff;     // per side (left, right): N + 1 offsets into plist
  const int* plist;    // per side: the nodes whose child is k, ascending,
                       //   at plist[side * N + poff[side * (N + 1) + k]..]
};

// The parent lists of both sides: for each node k, the nodes n whose
// left (right) child is k, in ascending n. One thread a (side, k) counts
// and then fills; two threads take the prefix sums.
__device__ __noinline__ void build_parents(int N, const int* lch,
                                           const int* rch, int* pcount,
                                           int* poff, int* plist) {
  for (int t = threadIdx.x; t < 2 * N; t += blockDim.x) {
    const int* idx = t < N ? lch : rch;
    const int k = t < N ? t : t - N;
    int c = 0;
    for (int n = 0; n < N; ++n) c += idx[n] == k;
    pcount[t] = c;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int* off = poff + threadIdx.x * (N + 1);
    off[0] = 0;
    for (int k = 0; k < N; ++k) off[k + 1] = off[k] + pcount[threadIdx.x * N + k];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * N; t += blockDim.x) {
    const int side = t < N ? 0 : 1;
    const int* idx = side ? rch : lch;
    const int k = t - side * N;
    int at = side * N + poff[side * (N + 1) + k];
    for (int n = 0; n < N; ++n)
      if (idx[n] == k) plist[at++] = n;
  }
  __syncthreads();
}

// Start copying W_m[:, c0 .. c0+hc) (m over wr, wl, wrt) into
// ws[(m din + k) Hc + i].
__device__ void stage_cols(float* ws, const Layer& p, int din, int H, int Hc,
                           int c0, int hc, bool vec) {
  const int w = vec ? 4 : 1;
  const int q = cdiv(hc, w), n = 3 * din * q;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int row = x / q, v = x - row * q;      // row = m din + k
    const int m = row / din, k = row - m * din;
    const float* src = (m == 0 ? p.wr : m == 1 ? p.wl : p.wt) + k * H + c0 + w * v;
    __pipeline_memcpy_async(ws + row * Hc + w * v, src, w * sizeof(float));
  }
}

// Start copying rows W_m[j0 .. j0+jc) into ws[(m Jc + jj) ldh + c].
__device__ void stage_rows(float* ws, const Layer& p, int H, int Jc, int ldh,
                           int j0, int jc, bool vec) {
  const int w = vec ? 4 : 1;
  const int q = cdiv(H, w), n = 3 * jc * q;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int row = x / q, v = x - row * q;      // row = m jc + jj
    const int m = row / jc, jj = row - m * jc;
    const float* src = (m == 0 ? p.wr : m == 1 ? p.wl : p.wt) + (j0 + jj) * H + w * v;
    __pipeline_memcpy_async(ws + (m * Jc + jj) * ldh + w * v, src,
                            w * sizeof(float));
  }
}

// Register tiles of the three products, nodes or rows by channels a thread:
// each operand loaded from shared memory serves a whole row or column of
// the tile. The phases are kept out of line (one copy of each in the
// binary, not one a call site): 3% faster on the card than inlined.
constexpr int kRN = 3, kRC = 2;      // recompute: nodes x channels
constexpr int kWJ = 4, kWC = 3;      // weight gradients: rows j x channels
constexpr int kIN = 3, kIJ = 2;      // input gradient: nodes x rows j

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// This block's channel slice of one layer's pre-mask activations:
// out[n ldo + i] = leaky_relu(s(n) hin[n].Wr[:, i] + s(l) hin[l].Wl[:, i]
//                             + s(r) hin[r].Wt[:, i] + b[c0 + i]),
// s(row) = msk[row] where hin holds pre-mask activations (`scaled`), else 1.
// Weights from ws (stage_cols' layout). A thread takes kRN nodes (g,
// g + Ng, ...) by kRC channels; four inputs come in one float4 load.
__device__ __noinline__ void recompute(const Tree& t,
                                       const float* __restrict__ hin, int ldi,
                                       int din, bool scaled,
                                       const float* __restrict__ ws, int Hc,
                                       int hc, const float* __restrict__ bias,
                                       float* out, int ldo) {
  const int N = t.N, Ng = cdiv(N, kRN), Cg = cdiv(hc, kRC);
  const float* w_r = ws;
  const float* w_l = ws + din * Hc;
  const float* w_t = ws + 2 * din * Hc;
  for (int item = threadIdx.x; item < Ng * Cg; item += blockDim.x) {
    const int g = item / Cg, i0 = (item - g * Cg) * kRC;
    int wi[kRC], so[kRN], lo[kRN], ro[kRN];
#pragma unroll
    for (int q = 0; q < kRC; ++q) wi[q] = imin(i0 + q, hc - 1);
    float as[kRN][kRC], al[kRN][kRC], ar[kRN][kRC];
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int n = g + j * Ng;
      const bool live = n < N;                   // idle slots read row N
      so[j] = (live ? n : N) * ldi;
      lo[j] = (live ? t.lch[n] : N) * ldi;
      ro[j] = (live ? t.rch[n] : N) * ldi;
#pragma unroll
      for (int q = 0; q < kRC; ++q) as[j][q] = al[j][q] = ar[j][q] = 0.f;
    }
    int k = 0;
    for (; k + 4 <= din; k += 4) {
      float4 hs[kRN], hl[kRN], hr[kRN];
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        hs[j] = ld4(hin + so[j] + k);
        hl[j] = ld4(hin + lo[j] + k);
        hr[j] = ld4(hin + ro[j] + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < kRC; ++q) {
          const int w = (k + kk) * Hc + wi[q];
          const float wr = w_r[w], wl = w_l[w], wt = w_t[w];
#pragma unroll
          for (int j = 0; j < kRN; ++j) {
            as[j][q] = fmaf(lane4(hs[j], kk), wr, as[j][q]);
            al[j][q] = fmaf(lane4(hl[j], kk), wl, al[j][q]);
            ar[j][q] = fmaf(lane4(hr[j], kk), wt, ar[j][q]);
          }
        }
      }
    }
    for (; k < din; ++k) {                       // din % 4 leftover inputs
#pragma unroll
      for (int q = 0; q < kRC; ++q) {
        const int w = k * Hc + wi[q];
        const float wr = w_r[w], wl = w_l[w], wt = w_t[w];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          as[j][q] = fmaf(hin[so[j] + k], wr, as[j][q]);
          al[j][q] = fmaf(hin[lo[j] + k], wl, al[j][q]);
          ar[j][q] = fmaf(hin[ro[j] + k], wt, ar[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int n = g + j * Ng;
      if (n >= N) break;
      const float ms = t.msk[n], ml = t.msk[t.lch[n]], mr = t.msk[t.rch[n]];
#pragma unroll
      for (int q = 0; q < kRC; ++q) {
        if (i0 + q >= hc) break;
        float v;
        if (scaled) {
          v = as[j][q] * ms;
          v += al[j][q] * ml;
          v += ar[j][q] * mr;
        } else {
          v = as[j][q] + al[j][q];
          v += ar[j][q];
        }
        out[n * ldo + i0 + q] = leaky(v + bias[i0 + q]);
      }
    }
  }
}

// g_h3 = d out / d h3 . g on this block's channels: g[c] split evenly
// among the masked nodes that hold the channel's maximum of h3 = a3 m +
// a2 m, rounded op by op as the plain version (no FMA contraction), so
// that its ties are the plain version's. One warp a channel, lanes over
// nodes (N <= 64).
__device__ __noinline__ void pool_backward(const Tree& t, const float* a3,
                                           int Hc, const float* a2, int lda2,
                                           int hc, const float* __restrict__ g,
                                           float* G, int Jc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < hc; i += blockDim.x >> 5) {
    float v[2];
    bool live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = lane + 32 * j;
      live[j] = n < t.N && t.msk[n] > 0.f;
      v[j] = live[j] ? __fadd_rn(__fmul_rn(a3[n * Hc + i], t.msk[n]),
                                 __fmul_rn(a2[n * lda2 + i], t.msk[n]))
                     : -INFINITY;
    }
    float mx = fmaxf(v[0], v[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const bool top0 = live[0] && v[0] == mx, top1 = live[1] && v[1] == mx;
    const int cnt = __popc(__ballot_sync(0xffffffffu, top0)) +
                    __popc(__ballot_sync(0xffffffffu, top1));
    const float share = cnt > 0 ? g[i] / static_cast<float>(cnt) : 0.f;
    if (lane < t.N) G[lane * Jc + i] = top0 ? share : 0.f;
    if (lane + 32 < t.N) G[(lane + 32) * Jc + i] = top1 ? share : 0.f;
  }
}

// One layer's g_z on this block's channels, from the cotangent gh = G of
// h = a m and the pre-mask activation a: x = gh m leaky_relu'(z), written
// to xo (which may be a's own slot: each element is read before it is
// written), and its scaled copies for the weight gradients xs = x s(n),
// xl = x s(left), xt = x s(right) (s as in `recompute`; all x when not
// scaled); gm[n] += sum_i gh a. One warp a node, lanes over channels.
__device__ __noinline__ void layer_grad(const Tree& t, const float* G, int Jc,
                                        const float* a, int lda, float* xo,
                                        int ldo, float* xs, int Hc, int hc,
                                        bool scaled, float* gm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = t.N;
  float* xl = xs + N * Hc;
  float* xt = xl + N * Hc;
  for (int n = warp; n < N; n += blockDim.x >> 5) {
    const float m = t.msk[n];
    float part = 0.f;
    if (lane < hc) {
      const float g = G[n * Jc + lane], av = a[n * lda + lane];
      part = g * av;
      float v = g * m;
      if (!(av > 0.f)) v *= 0.01f;
      xo[n * ldo + lane] = v;
      xs[n * Hc + lane] = scaled ? v * m : v;
      xl[n * Hc + lane] = scaled ? v * t.msk[t.lch[n]] : v;
      xt[n * Hc + lane] = scaled ? v * t.msk[t.rch[n]] : v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) gm[n] += part;
  }
}

// This block's channel slice of one layer's weight gradients into the
// tree's partial (3 (din, H) matrices, then b (H)): gWr[j, c] = sum_n
// hin[n, j] xs[n, i], gWl and gWt likewise over the left and right
// children with xl and xt, gb[c] = sum_n x[n, i], each sum over n in
// order. A thread takes kWJ = 4 rows j (one float4 of each input row) by
// kWC channels.
__device__ __noinline__ void weight_grads(const Tree& t,
                                          const float* __restrict__ hin,
                                          int ldi, int din, const float* xs,
                                          int Hc, int hc, const float* x,
                                          int ldx, int H, int c0,
                                          float* __restrict__ part) {
  const int N = t.N, Cg = cdiv(hc, kWC);
  const float* xl = xs + N * Hc;
  const float* xt = xl + N * Hc;
  for (int item = threadIdx.x; item < cdiv(din, kWJ) * Cg;
       item += blockDim.x) {
    const int jq = item / Cg, i0 = (item - jq * Cg) * kWC, j = kWJ * jq;
    int wi[kWC];
#pragma unroll
    for (int q = 0; q < kWC; ++q) wi[q] = imin(i0 + q, hc - 1);
    float sr[kWJ][kWC], sl[kWJ][kWC], st[kWJ][kWC], sb[kWC];
#pragma unroll
    for (int q = 0; q < kWC; ++q) {
      sb[q] = 0.f;
#pragma unroll
      for (int r = 0; r < kWJ; ++r) sr[r][q] = sl[r][q] = st[r][q] = 0.f;
    }
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      const float4 hn = ld4(hin + n * ldi + j);
      const float4 hl = ld4(hin + t.lch[n] * ldi + j);
      const float4 hr = ld4(hin + t.rch[n] * ldi + j);
#pragma unroll
      for (int q = 0; q < kWC; ++q) {
        const float vs = xs[n * Hc + wi[q]], vl = xl[n * Hc + wi[q]],
                    vt = xt[n * Hc + wi[q]];
#pragma unroll
        for (int r = 0; r < kWJ; ++r) {
          sr[r][q] = fmaf(lane4(hn, r), vs, sr[r][q]);
          sl[r][q] = fmaf(lane4(hl, r), vl, sl[r][q]);
          st[r][q] = fmaf(lane4(hr, r), vt, st[r][q]);
        }
        if (jq == 0) sb[q] += x[n * ldx + wi[q]];
      }
    }
#pragma unroll
    for (int q = 0; q < kWC; ++q) {
      if (i0 + q >= hc) break;
      const int c = c0 + i0 + q;
#pragma unroll
      for (int r = 0; r < kWJ; ++r) {
        if (j + r >= din) break;
        part[(j + r) * H + c] = sr[r][q];
        part[din * H + (j + r) * H + c] = sl[r][q];
        part[2 * din * H + (j + r) * H + c] = st[r][q];
      }
      if (jq == 0) part[3 * din * H + c] = sb[q];
    }
  }
}

// G[k, jj] (+)= sum_c X[k, c] Wr[j0 + jj, c] + sum over the nodes n whose
// left child is k of sum_c X[n, c] Wl[j0 + jj, c] + the same over right
// children with Wt, the parents in ascending n: each product summed over c
// in order, the self term first, then the left, then the right scatter.
// Weights from ws (stage_rows' layout). The two children's products go
// through p (2 x N x Jc) before the scatter. A thread takes kIN nodes (g,
// g + Ng, ...) by kIJ rows jj.
__device__ __noinline__ void input_grad(const Tree& t,
                                        const float* __restrict__ X, int ldx,
                                        int H, const float* __restrict__ ws,
                                        int Jc, int ldw, int jc, float* G,
                                        bool accumulate, float* p) {
  const int N = t.N, Ng = cdiv(N, kIN), Jg = cdiv(jc, kIJ);
  float* pl = p;
  float* pt = p + N * Jc;
  for (int item = threadIdx.x; item < Ng * Jg; item += blockDim.x) {
    const int g = item / Jg, j0 = (item - g * Jg) * kIJ;
    const float* wr[kIJ];
    const float* wl[kIJ];
    const float* wt[kIJ];
    const float* x[kIN];
#pragma unroll
    for (int q = 0; q < kIJ; ++q) {
      const int jj = imin(j0 + q, jc - 1);
      wr[q] = ws + jj * ldw;
      wl[q] = ws + (Jc + jj) * ldw;
      wt[q] = ws + (2 * Jc + jj) * ldw;
    }
    float s[kIN][kIJ], l[kIN][kIJ], r[kIN][kIJ];
#pragma unroll
    for (int j = 0; j < kIN; ++j) {
      x[j] = X + imin(g + j * Ng, N - 1) * ldx;
#pragma unroll
      for (int q = 0; q < kIJ; ++q) s[j][q] = l[j][q] = r[j][q] = 0.f;
    }
    int c = 0;
    for (; c + 4 <= H; c += 4) {
      float4 xv[kIN];
#pragma unroll
      for (int j = 0; j < kIN; ++j) xv[j] = ld4(x[j] + c);
#pragma unroll
      for (int q = 0; q < kIJ; ++q) {
        const float4 a = ld4(wr[q] + c), b = ld4(wl[q] + c), d = ld4(wt[q] + c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < kIN; ++j) {
            const float v = lane4(xv[j], kk);
            s[j][q] = fmaf(v, lane4(a, kk), s[j][q]);
            l[j][q] = fmaf(v, lane4(b, kk), l[j][q]);
            r[j][q] = fmaf(v, lane4(d, kk), r[j][q]);
          }
        }
      }
    }
    for (; c < H; ++c) {
#pragma unroll
      for (int q = 0; q < kIJ; ++q) {
#pragma unroll
        for (int j = 0; j < kIN; ++j) {
          s[j][q] = fmaf(x[j][c], wr[q][c], s[j][q]);
          l[j][q] = fmaf(x[j][c], wl[q][c], l[j][q]);
          r[j][q] = fmaf(x[j][c], wt[q][c], r[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kIN; ++j) {
      const int n = g + j * Ng;
      if (n >= N) break;
#pragma unroll
      for (int q = 0; q < kIJ; ++q) {
        if (j0 + q >= jc) break;
        const int at = n * Jc + j0 + q;
        G[at] = accumulate ? G[at] + s[j][q] : s[j][q];
        pl[at] = l[j][q];
        pt[at] = r[j][q];
      }
    }
  }
  __syncthreads();
  for (int item = threadIdx.x; item < N * jc; item += blockDim.x) {
    const int k = item / jc, jj = item - k * jc;
    float g = G[k * Jc + jj];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int* off = t.poff + side * (N + 1);
      const int* list = t.plist + side * N;
      const float* src = side ? pt : pl;
      const int a = off[k], b = off[k + 1];
      if (a == b) continue;
      float acc = 0.f;
      for (int q = a; q < b; ++q) acc += src[list[q] * Jc + jj];
      g += acc;
    }
    G[k * Jc + jj] = g;
  }
}

// Copy the other blocks' channel slices of `buf` (rows < N) into this
// block's copy, W floats at a time; all loads of a batch are issued before
// any of its stores.
template <int W>
__device__ void gather_slices(cg::cluster_group& cluster, float* buf, int ld,
                              int N, int H, int Hc, int rank) {
  using V = typename std::conditional<W == 4, float4, float>::type;
  constexpr int kBatch = 4;
  const int q = Hc / W, per = N * q, total = (kCluster - 1) * per;
  const int nthreads = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kBatch * nthreads) {
    V v[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int x = base + b * nthreads;
      dst[b] = -1;
      if (x < total) {
        int r = x / per;
        const int rem = x - r * per;
        r += (r >= rank);                        // skip our own slice
        const int n = rem / q, col = r * Hc + W * (rem - n * q);
        if (col < H) {
          dst[b] = n * ld + col;
          v[b] = *reinterpret_cast<const V*>(
              cluster.map_shared_rank(buf, r) + dst[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (dst[b] >= 0) *reinterpret_cast<V*>(buf + dst[b]) = v[b];
  }
}

__device__ __forceinline__ void gather(cg::cluster_group& cluster, float* buf,
                                       int ld, int N, int H, int Hc,
                                       int rank) {
  if (Hc % 4 == 0 && H % 4 == 0)
    gather_slices<4>(cluster, buf, ld, N, H, Hc, rank);
  else
    gather_slices<1>(cluster, buf, ld, N, H, Hc, rank);
}

// Launch bounds for two blocks an SM: up to 128 registers a thread at 256.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 2) tree_cnn_fused_bwd_kernel(
        const float* __restrict__ feat, const int* __restrict__ left,
        const int* __restrict__ right, const float* __restrict__ mask,
        const Layer l1, const Layer l2, const Layer l3,
        const float* __restrict__ gout, float* __restrict__ partial,
        float* __restrict__ gfeat, float* __restrict__ gmask, int N, int F,
        int H) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];              // 16-byte aligned
  float* sm = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(N, F, H);
  const int Hc = P.Hc, Jc = P.Jc, ldh = P.ldh, ldf = P.ldf;
  float* h0 = sm + P.h0;
  float* A = sm + P.A;
  float* B = sm + P.B;
  float* S2 = sm + P.S2;
  float* S3 = sm + P.S3;
  float* G = sm + P.G;
  float* XS = sm + P.XS;
  float* ring = sm + P.ring;
  float* gm = sm + P.gm;
  float* msk = sm + P.msk;
  int* lch = reinterpret_cast<int*>(sm + P.ints);
  int* rch = lch + N;
  int* pcount = rch + N;                         // 2N
  int* poff = pcount + 2 * N;                    // 2 (N + 1)
  int* plist = poff + 2 * (N + 1);               // 2N

  const int rank = static_cast<int>(cluster.block_rank());
  const int tree = blockIdx.x / kCluster, tid = threadIdx.x;
  const int c0 = rank * Hc, hc = imax(0, imin(Hc, H - c0));
  const int f0 = rank * P.Fc, fc = imax(0, imin(P.Fc, F - f0));
  const size_t row0 = static_cast<size_t>(tree) * N;
  const bool need_in1 = gfeat != nullptr || gmask != nullptr;
  const bool al = aligned16(l1.wr) && aligned16(l1.wl) && aligned16(l1.wt) &&
                  aligned16(l2.wr) && aligned16(l2.wl) && aligned16(l2.wt) &&
                  aligned16(l3.wr) && aligned16(l3.wl) && aligned16(l3.wt);
  const bool vec_cols = al && Hc % 4 == 0 && H % 4 == 0;
  const bool vec_rows = al && H % 4 == 0;

  // The weight sets in phase order: the recompute's W[:, c-slice] of
  // layers 1..3, then the input gradient's W[j-slice, :] of layers 3, 2
  // (and 1). Set s + 1 is copied into the ring as soon as phase s is done
  // reading it, under the phases between (weight gradients, gathers).
  auto issue = [&](int s) {
    if (s == 0) stage_cols(ring, l1, F, H, Hc, c0, hc, vec_cols);
    else if (s == 1) stage_cols(ring, l2, H, H, Hc, c0, hc, vec_cols);
    else if (s == 2) stage_cols(ring, l3, H, H, Hc, c0, hc, vec_cols);
    else if (s == 3) stage_rows(ring, l3, H, Jc, ldh, c0, hc, vec_rows);
    else if (s == 4) stage_rows(ring, l2, H, Jc, ldh, c0, hc, vec_rows);
    else if (s == 5 && need_in1) stage_rows(ring, l1, H, Jc, ldh, f0, fc, vec_rows);
    __pipeline_commit();
  };
  auto acquire = [&]() {                         // the set in the ring landed
    __pipeline_wait_prior(0);
    __syncthreads();
  };
  auto release = [&](int s) {                    // the ring is free
    __syncthreads();
    issue(s + 1);
  };

  issue(0);
  for (int n = tid; n < N; n += blockDim.x) {
    const int l = left[row0 + n], r = right[row0 + n];
    lch[n] = (l >= 0 && l < N) ? l : N;
    rch[n] = (r >= 0 && r < N) ? r : N;
    msk[n] = mask[row0 + n];
    gm[n] = 0.f;
  }
  if (tid == 0) msk[N] = 0.f;
  const float* ft = feat + row0 * F;
  for (int x = tid; x < N * F; x += blockDim.x) {
    const int n = x / F;
    h0[n * ldf + (x - n * F)] = ft[x] * mask[row0 + n];
  }
  for (int x = tid; x < ldf; x += blockDim.x) h0[N * ldf + x] = 0.f;
  for (int x = tid; x < ldh; x += blockDim.x) A[N * ldh + x] = B[N * ldh + x] = 0.f;
  __syncthreads();
  build_parents(N, lch, rch, pcount, poff, plist);
  const Tree t{N, lch, rch, msk, poff, plist};

  float* part1 = partial + static_cast<size_t>(tree) *
                               (3 * F * H + H + 2 * (3 * H * H + H));
  float* part2 = part1 + 3 * F * H + H;
  float* part3 = part2 + 3 * H * H + H;

  // recompute: a1, a2 all-gathered; a3 on this block's channels only
  acquire();
  recompute(t, h0, ldf, F, false, ring, Hc, hc, l1.b + c0, A + c0, ldh);
  release(0);
  cluster.sync();                                // every slice of a1 written
  gather(cluster, A, ldh, N, H, Hc, rank);
  acquire();
  recompute(t, A, ldh, H, true, ring, Hc, hc, l2.b + c0, B + c0, ldh);
  release(1);
  cluster.sync();                                // a2 written, a1 gathered
  gather(cluster, B, ldh, N, H, Hc, rank);
  cluster_arrive();                              // done reading others' a2
  for (int x = tid; x < N * hc; x += blockDim.x) {
    const int n = x / hc, i = x - n * hc;
    S2[n * Hc + i] = B[n * ldh + c0 + i];
  }
  acquire();
  recompute(t, B, ldh, H, true, ring, Hc, hc, l3.b + c0, S3, Hc);
  release(2);

  // layer 3: g_h3 from the pool (kept in G: the residual's share of
  // g_h2), g_z3 over a3 in S3, then into B's own columns for the gather
  pool_backward(t, S3, Hc, S2, Hc, hc,
                gout + static_cast<size_t>(tree) * H + c0, G, Jc);
  __syncthreads();
  layer_grad(t, G, Jc, S3, Hc, S3, Hc, XS, Hc, hc, true, gm);
  __syncthreads();
  weight_grads(t, B, ldh, H, XS, Hc, hc, S3, Hc, H, c0, part3);
  __syncthreads();                               // this block is done with
  cluster_wait();                                //   a2 in B, and so are the
  for (int x = tid; x < N * hc; x += blockDim.x) {   // others with its slice
    const int n = x / hc, i = x - n * hc;
    B[n * ldh + c0 + i] = S3[n * Hc + i];
  }
  cluster.sync();                                // every slice of g_z3 in B
  gather(cluster, B, ldh, N, H, Hc, rank);
  cluster_arrive();                              // done reading others' g_z3
  acquire();
  input_grad(t, B, ldh, H, ring, Jc, ldh, hc, G, true, XS);   // g_h2
  release(3);

  // layer 2: g_z2 over a2 in S2, into B's own columns once no block reads
  // g_z3 there any more
  cluster_wait();
  layer_grad(t, G, Jc, S2, Hc, B + c0, ldh, XS, Hc, hc, true, gm);
  __syncthreads();
  weight_grads(t, A, ldh, H, XS, Hc, hc, B + c0, ldh, H, c0, part2);
  cluster.sync();                                // every slice of g_z2 in B
  gather(cluster, B, ldh, N, H, Hc, rank);
  acquire();
  input_grad(t, B, ldh, H, ring, Jc, ldh, hc, G, false, XS);  // g_h1
  release(4);

  // layer 1: g_z1 over a1's own columns of A
  layer_grad(t, G, Jc, A + c0, ldh, A + c0, ldh, XS, Hc, hc, false, gm);
  __syncthreads();
  weight_grads(t, h0, ldf, F, XS, Hc, hc, A + c0, ldh, H, c0, part1);
  if (need_in1) {
    cluster.sync();                              // g_z1 written, g_z2 gathered
    gather(cluster, A, ldh, N, H, Hc, rank);
    acquire();
    input_grad(t, A, ldh, H, ring, Jc, ldh, fc, G, false, XS);  // g_h0
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    for (int n = warp; n < N; n += blockDim.x >> 5) {
      float part = 0.f;
      if (lane < fc) {
        const float g = G[n * Jc + lane];
        part = g * ft[n * F + f0 + lane];
        if (gfeat != nullptr) gfeat[(row0 + n) * F + f0 + lane] = g * msk[n];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) gm[n] += part;
    }
    cluster.sync();                              // every partial of gmask
    if (gmask != nullptr) {
      const int nc = cdiv(N, kCluster), n = rank * nc + tid;   // this rank's
      if (tid < nc && n < N) {
        float s = 0.f;
        for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(gm, q)[n];
        gmask[row0 + n] = s;
      }
    }
  }
  cluster.sync();                                // no block leaves while
                                                 // another may still read it
}

// out[e] = sum over trees t, in order, of partial[t, e]; four elements a
// thread (one float4 a tree where E and the rows allow), eight trees'
// loads in flight.
__global__ void sum_trees_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int B, int E) {
  const int e = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= E) return;
  if (E % 4 == 0) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          partial + static_cast<size_t>(t) * E + e));
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + e) = s;
    return;
  }
  for (int q = e; q < imin(e + 4, E); ++q) {
    float s = 0.f;
#pragma unroll 8
    for (int t = 0; t < B; ++t) s += __ldg(partial + static_cast<size_t>(t) * E + q);
    out[q] = s;
  }
}

__host__ __device__ inline int layer_size(int din, int H) { return 3 * din * H + H; }

size_t smem_bytes(int N, int F, int H) {
  return sizeof(float) * make_plan(N, F, H).total;
}

cudaError_t opt_in(size_t smem) {
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_cnn_fused_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  return cudaSuccess;
}

bool valid(int N, int F, int H) {
  return N >= 1 && N <= kMaxNodes && F >= 1 && F <= kMaxWidth && H >= 1 &&
         H <= kMaxWidth && smem_bytes(N, F, H) <= kMaxSmem;
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous fp32 (int32 for left/right) tensors; gfeat and gmask may be
// null. `partial` holds B x E floats of scratch and `gw` E floats, E =
// the 12 weights' element count, conv1..conv3 x (wr, wl, wrt, b). Two
// launches on `stream`; returns cudaGetLastError() after them (0 =
// launched).
extern "C" int tree_cnn_fused_backward(
    const float* feat, const int* left, const int* right, const float* mask,
    const float* w1r, const float* w1l, const float* w1t, const float* b1,
    const float* w2r, const float* w2l, const float* w2t, const float* b2,
    const float* w3r, const float* w3l, const float* w3t, const float* b3,
    const float* gout, float* partial, float* gw, float* gfeat, float* gmask,
    int B, int N, int F, int H, void* stream) {
  if (B < 0 || !valid(N, F, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = layer_size(F, H) + 2 * layer_size(H, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaMemsetAsync(gw, 0, E * sizeof(float), s));
  const Layer l1{w1r, w1l, w1t, b1}, l2{w2r, w2l, w2t, b2},
      l3{w3r, w3l, w3t, b3};
  const size_t smem = smem_bytes(N, F, H);
  cudaError_t e = opt_in(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tree_cnn_fused_bwd_kernel<<<B * kCluster, kThreads, smem, s>>>(
      feat, left, right, mask, l1, l2, l3, gout, partial, gfeat, gmask, N, F,
      H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_trees_kernel<<<cdiv(cdiv(E, 4), 256), 256, 0, s>>>(partial, gw, B, E);
  return static_cast<int>(cudaGetLastError());
}

// The per-tree kernel's launch shape and occupancy at (N, F, H): out =
// {blocks a tree, threads a block, shared-memory bytes a block, blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), clusters the card
// holds at once (cudaOccupancyMaxActiveClusters)}. Returns a CUDA error
// code.
extern "C" int tree_cnn_fused_backward_occupancy(int N, int F, int H,
                                                 int* out) {
  if (!valid(N, F, H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, F, H);
  cudaError_t e = opt_in(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = static_cast<int>(smem);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, tree_cnn_fused_bwd_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out + 4, tree_cnn_fused_bwd_kernel, &cfg));
}
