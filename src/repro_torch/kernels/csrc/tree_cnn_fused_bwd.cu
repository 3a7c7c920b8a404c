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
// are ~0.42 GFLOP of fp32 FMAs, ~6 us at 67 TFLOP/s; the bytes (inputs,
// weights, gradients, ~0.6 MB, plus 2 x 24 x 251 KB of per-tree partials)
// take ~3.6 us at 3.35 TB/s. So operations and latency bound it.
//
// Design (simple first): one 1024-thread block per tree. The tree's h0 and
// a1..a3 stay in shared memory, with the gradient buffers (g_z, g_h and one
// product buffer), ~100 KB at N = 48, H = 96 (~200 KB at N = 64, H = 128);
// the weights are read from L2. Every product keeps its sums in registers:
// lanes over output channels where the other operand is broadcast, lanes
// over nodes (rows of odd stride, so no bank conflicts) for g_z W^T, where
// the weight row is broadcast. The children's scatter-add is a gather over
// each node's parents, listed in ascending order once per tree. Each tree writes its weight-gradient partial
// to global memory; a second launch sums them over the trees in tree order.
// No float atomics anywhere, so the result repeats bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 64;
constexpr int kMaxWidth = 128;                   // F and H
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;     // rows a thread, lanes over columns
constexpr int kCols = 4;     // columns a thread, lanes over rows

struct Layer {
  const float* wr;   // (din, H), used as x @ W
  const float* wl;
  const float* wt;
  const float* b;    // (H,)
};

// Row strides: odd, so 32 lanes reading one column of 32 rows hit 32 banks.
__host__ __device__ constexpr int odd_ld(int d) { return d | 1; }

struct Tree {
  int N;
  const int* lch;      // child index, N where outside [0, N)
  const int* rch;
  const float* msk;    // N + 1 entries, msk[N] = 0
  const float* zrow;   // a row of zeros
  const int* poff;     // per side (left, right): N + 1 offsets into plist
  const int* plist;    // per side: the nodes whose child is k, ascending,
                       //   at plist[side * N + poff[side * (N + 1) + k]..]
};

// The parent lists of both sides: for each node k, the nodes n whose
// left (right) child is k, in ascending n. One thread a (side, k) counts
// and then fills; two threads take the prefix sums.
__device__ void build_parents(int N, const int* lch, const int* rch,
                              int* pcount, int* poff, int* plist) {
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

// a_out[n, c] = leaky_relu(s(n) hin[n].Wr[:, c] + s(l) hin[l].Wl[:, c]
//                          + s(r) hin[r].Wt[:, c] + b[c]),
// s(row) = msk[row] where hin holds pre-mask activations, else 1.
__device__ void forward_layer(const Tree& t, const float* hin, int ldi,
                              int din, bool scaled, const Layer p,
                              float* aout, int ldo, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = t.N;
  const int rblocks = (N + kRows - 1) / kRows, cblocks = (H + 31) / 32;
  for (int item = warp; item < rblocks * cblocks; item += kWarps) {
    const int rb = item / cblocks, c = (item % cblocks) * 32 + lane;
    const int cc = c < H ? c : H - 1;
    const float* ps[kRows];
    const float* pl[kRows];
    const float* pr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int n = rb * kRows + i;
      if (n < N) {
        const int l = t.lch[n], r = t.rch[n];
        ps[i] = hin + n * ldi;
        pl[i] = l < N ? hin + l * ldi : t.zrow;
        pr[i] = r < N ? hin + r * ldi : t.zrow;
      } else {
        ps[i] = pl[i] = pr[i] = t.zrow;
      }
    }
    float as[kRows], al[kRows], ar[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) as[i] = al[i] = ar[i] = 0.f;
    const float* wr = p.wr + cc;
    const float* wl = p.wl + cc;
    const float* wt = p.wt + cc;
#pragma unroll 2
    for (int k = 0; k < din; ++k) {
      const float vr = __ldg(wr + k * H), vl = __ldg(wl + k * H),
                  vt = __ldg(wt + k * H);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        as[i] = fmaf(ps[i][k], vr, as[i]);
        al[i] = fmaf(pl[i][k], vl, al[i]);
        ar[i] = fmaf(pr[i][k], vt, ar[i]);
      }
    }
    if (c >= H) continue;
    const float bias = __ldg(p.b + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int n = rb * kRows + i;
      if (n >= N) break;
      float v;
      if (scaled) {
        v = as[i] * t.msk[n];
        v += al[i] * t.msk[t.lch[n]];
        v += ar[i] * t.msk[t.rch[n]];
      } else {
        v = as[i] + al[i];
        v += ar[i];
      }
      v += bias;
      aout[n * ldo + c] = v > 0.f ? v : 0.01f * v;
    }
  }
}

// h3 = a3 * m + h2, h2 = a2 * m, rounded op by op as the plain version
// (no contraction into an FMA), so that its ties are the plain version's.
__device__ __forceinline__ float h3_at(const float* a2, int ld2,
                                       const float* a3, int ld3, int n, int c,
                                       float m) {
  return __fadd_rn(__fmul_rn(a3[n * ld3 + c], m), __fmul_rn(a2[n * ld2 + c], m));
}

// g_h3 = d out / d h3 . g: g[c] split evenly among the masked nodes that
// hold the channel's maximum of h3.
__device__ void pool_backward(const Tree& t, const float* a2, int ld2,
                              const float* a3, int ld3, const float* g,
                              float* x, int ldx, int H) {
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float mx = -INFINITY;
    int cnt = 0;
    for (int n = 0; n < t.N; ++n) {
      if (!(t.msk[n] > 0.f)) continue;
      const float h3 = h3_at(a2, ld2, a3, ld3, n, c, t.msk[n]);
      if (h3 > mx) { mx = h3; cnt = 1; } else if (h3 == mx) { ++cnt; }
    }
    const float share = cnt > 0 ? g[c] / static_cast<float>(cnt) : 0.f;
    for (int n = 0; n < t.N; ++n) {
      float v = 0.f;
      if (cnt > 0 && t.msk[n] > 0.f &&
          h3_at(a2, ld2, a3, ld3, n, c, t.msk[n]) == mx)
        v = share;
      x[n * ldx + c] = v;
    }
  }
}

// For one layer with pre-mask activation a and the total cotangent gh of
// h = a * m: gm[n] += sum_c gh[n, c] a[n, c] and x = g_z = gh * m *
// leaky_relu'(z). With `keep`, gh is copied into `a`'s slot as it goes (the
// residual's share of g_h2). gh and x may be one buffer. One warp a row.
__device__ void layer_grad(const Tree& t, float* a, int lda, const float* gh,
                           int ldg, float* x, int ldx, float* gm, int H,
                           bool keep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < t.N; n += kWarps) {
    const float m = t.msk[n];
    float part = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float g = gh[n * ldg + c], av = a[n * lda + c];
      part = fmaf(g, av, part);
      float v = g * m;
      if (!(av > 0.f)) v *= 0.01f;
      if (keep) a[n * lda + c] = g;
      x[n * ldx + c] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) gm[n] += part;
  }
}

// The layer's weight gradients into this tree's partial: with s as in
// forward_layer, gWr[j, c] = sum_n hin[n, j] s(n) x[n, c], gWl and gWt
// likewise over the left and right children, gb[c] = sum_n x[n, c].
__device__ void weight_grads(const Tree& t, const float* hin, int ldi,
                             int din, bool scaled, const float* x, int ldx,
                             int H, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = t.N;
  const int rblocks = (din + kRows - 1) / kRows, cblocks = (H + 31) / 32;
  float* gwr = part;
  float* gwl = part + din * H;
  float* gwt = part + 2 * din * H;
  float* gb = part + 3 * din * H;
  for (int item = warp; item < rblocks * cblocks; item += kWarps) {
    const int jb = item / cblocks, c = (item % cblocks) * 32 + lane;
    const int cc = c < H ? c : H - 1;
    int js[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int j = jb * kRows + i;
      js[i] = j < din ? j : din - 1;
    }
    float sr[kRows], sl[kRows], st[kRows], sb = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) sr[i] = sl[i] = st[i] = 0.f;
    for (int n = 0; n < N; ++n) {
      const int l = t.lch[n], r = t.rch[n];
      const float xv = x[n * ldx + cc];
      sb += xv;
      const float xr = scaled ? xv * t.msk[n] : xv;
      const float xl = scaled ? xv * t.msk[l] : xv;
      const float xt = scaled ? xv * t.msk[r] : xv;
      const float* hn = hin + n * ldi;
      const float* hl = l < N ? hin + l * ldi : t.zrow;
      const float* hr = r < N ? hin + r * ldi : t.zrow;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        sr[i] = fmaf(hn[js[i]], xr, sr[i]);
        sl[i] = fmaf(hl[js[i]], xl, sl[i]);
        st[i] = fmaf(hr[js[i]], xt, st[i]);
      }
    }
    if (c >= H) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int j = jb * kRows + i;
      if (j >= din) break;
      gwr[j * H + c] = sr[i];
      gwl[j * H + c] = sl[i];
      gwt[j * H + c] = st[i];
    }
    if (jb == 0) gb[c] = sb;
  }
}

// dst[k, j] (+)= sum_c x[k, c] W[j, c] for k < N, j < din: lanes over the
// nodes k, kCols columns j a thread, the weight row read once for the warp.
__device__ void times_wt(const Tree& t, const float* x, int ldx,
                         const float* W, int din, int H, float* dst,
                         int ldd, bool accumulate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rblocks = (t.N + 31) / 32, cblocks = (din + kCols - 1) / kCols;
  for (int item = warp; item < rblocks * cblocks; item += kWarps) {
    const int k = (item / cblocks) * 32 + lane, jb = item % cblocks;
    const float* xr = x + (k < t.N ? k : 0) * ldx;
    const float* w[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = jb * kCols + q;
      w[q] = W + (j < din ? j : din - 1) * H;
    }
    float acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int c = 0; c < H; ++c) {
      const float xv = xr[c];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = fmaf(xv, __ldg(w[q] + c), acc[q]);
    }
    if (k >= t.N) continue;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = jb * kCols + q;
      if (j >= din) break;
      dst[k * ldd + j] = accumulate ? dst[k * ldd + j] + acc[q] : acc[q];
    }
  }
}

// dst[k, j] += sum over the nodes n whose child on `side` is k, in
// ascending n, of src[n, j].
__device__ void scatter_children(const Tree& t, int side, const float* src,
                                 int lds, int din, float* dst, int ldd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cblocks = (din + 31) / 32;
  const int* off = t.poff + side * (t.N + 1);
  const int* list = t.plist + side * t.N;
  for (int item = warp; item < t.N * cblocks; item += kWarps) {
    const int k = item / cblocks, j = (item % cblocks) * 32 + lane;
    const int a = off[k], b = off[k + 1];
    if (j >= din || a == b) continue;
    float acc = 0.f;
    for (int i = a; i < b; ++i) acc += src[list[i] * lds + j];
    dst[k * ldd + j] += acc;
  }
}

// g_hin (dst, accumulate or overwrite) = x Wr^T + scatter_l(x Wl^T) +
// scatter_r(x Wt^T), through the product buffer p.
__device__ void input_grad(const Tree& t, const float* x, int ldx,
                           const Layer L, int din, int H, float* dst,
                           int ldd, bool accumulate, float* p, int ldp) {
  times_wt(t, x, ldx, L.wr, din, H, dst, ldd, accumulate);
  times_wt(t, x, ldx, L.wl, din, H, p, ldp, false);
  __syncthreads();
  scatter_children(t, 0, p, ldp, din, dst, ldd);
  __syncthreads();
  times_wt(t, x, ldx, L.wt, din, H, p, ldp, false);
  __syncthreads();
  scatter_children(t, 1, p, ldp, din, dst, ldd);
  __syncthreads();
}

__host__ __device__ inline int layer_size(int din, int H) { return 3 * din * H + H; }

size_t smem_floats(int N, int F, int H) {
  const int D = F > H ? F : H;
  const int ldf = odd_ld(F), ldh = odd_ld(H), ldd = odd_ld(D);
  return static_cast<size_t>(N) * (ldf + 3 * ldh + 2 * ldd) + ldd +
         (N + 1) + N + 8 * N + 2;
}

__global__ void __launch_bounds__(kThreads) tree_cnn_fused_bwd_kernel(
    const float* __restrict__ feat, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ mask,
    const Layer l1, const Layer l2, const Layer l3,
    const float* __restrict__ gout, float* __restrict__ partial,
    float* __restrict__ gfeat, float* __restrict__ gmask, int N, int F,
    int H) {
  extern __shared__ float smem[];
  const int D = F > H ? F : H;
  const int ldf = odd_ld(F), ldh = odd_ld(H), ldd = odd_ld(D);
  float* h0 = smem;                    // N x ldf, feat * mask
  float* a1 = h0 + N * ldf;            // N x ldh, pre-mask activations
  float* a2 = a1 + N * ldh;
  float* x = a2 + N * ldh;             // N x ldh, g_z of the current layer
  float* y = x + N * ldh;              // N x ldd: a3, then g_h, then g_h0
  float* p = y + N * ldd;              // N x ldd, x W^T before its scatter
  float* zrow = p + N * ldd;           // ldd zeros
  float* msk = zrow + ldd;             // N + 1, msk[N] = 0
  float* gm = msk + N + 1;             // N, d out / d mask
  int* lch = reinterpret_cast<int*>(gm + N);
  int* rch = lch + N;
  int* pcount = rch + N;               // 2N
  int* poff = pcount + 2 * N;          // 2 (N + 1)
  int* plist = poff + 2 * (N + 1);     // 2N
  float* a3 = y;
  const int ldy = ldd;

  const int tree = blockIdx.x, tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(tree) * N;
  for (int n = tid; n < N; n += blockDim.x) {
    const int l = left[row0 + n], r = right[row0 + n];
    lch[n] = (l >= 0 && l < N) ? l : N;
    rch[n] = (r >= 0 && r < N) ? r : N;
    msk[n] = mask[row0 + n];
    gm[n] = 0.f;
  }
  if (tid == 0) msk[N] = 0.f;
  for (int i = tid; i < ldd; i += blockDim.x) zrow[i] = 0.f;
  const float* ft = feat + row0 * F;
  for (int i = tid; i < N * F; i += blockDim.x) {
    const int n = i / F;
    h0[n * ldf + (i - n * F)] = ft[i] * mask[row0 + n];
  }
  __syncthreads();
  build_parents(N, lch, rch, pcount, poff, plist);
  const Tree t{N, lch, rch, msk, zrow, poff, plist};

  // recompute the forward
  forward_layer(t, h0, ldf, F, false, l1, a1, ldh, H);
  __syncthreads();
  forward_layer(t, a1, ldh, H, true, l2, a2, ldh, H);
  __syncthreads();
  forward_layer(t, a2, ldh, H, true, l3, a3, ldy, H);
  __syncthreads();

  float* part = partial + static_cast<size_t>(tree) *
                              (layer_size(F, H) + 2 * layer_size(H, H));
  float* part1 = part;
  float* part2 = part1 + layer_size(F, H);
  float* part3 = part2 + layer_size(H, H);

  // layer 3: g_h3 from the pool, the residual's share kept in y
  pool_backward(t, a2, ldh, a3, ldy, gout + static_cast<size_t>(tree) * H,
                x, ldh, H);
  __syncthreads();
  layer_grad(t, a3, ldy, x, ldh, x, ldh, gm, H, true);
  __syncthreads();
  weight_grads(t, a2, ldh, H, true, x, ldh, H, part3);
  input_grad(t, x, ldh, l3, H, H, y, ldy, true, p, ldd);     // g_h2 in y

  // layer 2
  layer_grad(t, a2, ldh, y, ldy, x, ldh, gm, H, false);
  __syncthreads();
  weight_grads(t, a1, ldh, H, true, x, ldh, H, part2);
  input_grad(t, x, ldh, l2, H, H, y, ldy, false, p, ldd);    // g_h1 in y

  // layer 1
  layer_grad(t, a1, ldh, y, ldy, x, ldh, gm, H, false);
  __syncthreads();
  weight_grads(t, h0, ldf, F, false, x, ldh, H, part1);
  if (gfeat == nullptr && gmask == nullptr) return;
  input_grad(t, x, ldh, l1, F, H, y, ldy, false, p, ldd);    // g_h0 in y

  const int lane = tid & 31, warp = tid >> 5;
  for (int n = warp; n < N; n += kWarps) {
    const float m = msk[n];
    float part_m = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float g = y[n * ldy + f];
      part_m = fmaf(g, ft[n * F + f], part_m);
      if (gfeat != nullptr) gfeat[(row0 + n) * F + f] = g * m;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part_m += __shfl_xor_sync(0xffffffffu, part_m, o);
    if (lane == 0 && gmask != nullptr) gmask[row0 + n] = gm[n] + part_m;
  }
}

// out[e] = sum over trees t, in order, of partial[t, e].
__global__ void sum_trees_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int B, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int t = 0; t < B; ++t) s += partial[static_cast<size_t>(t) * E + e];
  out[e] = s;
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous fp32 (int32 for left/right) tensors; gfeat and gmask may be
// null. `partial` holds B x E floats of scratch and `gw` E floats, E =
// the 12 weights' element count, conv1..conv3 x (wr, wl, wrt, b). Two
// launches on `stream`; returns cudaGetLastError() after them (0 = launched).
extern "C" int tree_cnn_fused_backward(
    const float* feat, const int* left, const int* right, const float* mask,
    const float* w1r, const float* w1l, const float* w1t, const float* b1,
    const float* w2r, const float* w2l, const float* w2t, const float* b2,
    const float* w3r, const float* w3l, const float* w3t, const float* b3,
    const float* gout, float* partial, float* gw, float* gfeat, float* gmask,
    int B, int N, int F, int H, void* stream) {
  if (B < 0 || N < 1 || N > kMaxNodes || F < 1 || F > kMaxWidth || H < 1 ||
      H > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = layer_size(F, H) + 2 * layer_size(H, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaMemsetAsync(gw, 0, E * sizeof(float), s));
  const Layer l1{w1r, w1l, w1t, b1}, l2{w2r, w2l, w2t, b2},
      l3{w3r, w3l, w3t, b3};
  const size_t smem = smem_floats(N, F, H) * sizeof(float);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_cnn_fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  tree_cnn_fused_bwd_kernel<<<B, kThreads, smem, s>>>(
      feat, left, right, mask, l1, l2, l3, gout, partial, gfeat, gmask, N, F,
      H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_trees_kernel<<<(E + 255) / 256, 256, 0, s>>>(partial, gw, B, E);
  return static_cast<int>(cudaGetLastError());
}
