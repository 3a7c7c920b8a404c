// Fused TreeCNN encoder forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/tree_conv.py::tree_cnn_fused
// (_fused_kernel). Per tree: three Neo tree-conv layers
//   h' = leaky_relu_0.01(h Wr + h[left] Wl + h[right] Wrt + b) * mask,
// a residual on layer 3 (h3 += h2) and a masked max-pool over the nodes
// (all-masked -> 0): feat (B, N, F) -> out (B, H).
//
// Bound on an H100: at the serving shape (B=8, N=48, F=26, H=96) a call does
// ~48 MFLOP and reads ~0.3 MB (mostly the 251 KB of weights), under a
// microsecond at the card's peaks, so latency bounds it: the launch, and the
// chain of dependent steps inside (loads, three layers, the pool). The TPU
// version turned each child gather into a one-hot matmul; here the gather is
// a direct shared-memory read.
//
// Design: one thread-block cluster of kCluster blocks per tree, so a batch
// of 8 trees occupies 64 SMs instead of 8. Block r owns output channels
// [r*Hc, (r+1)*Hc), Hc = H/kCluster. Every block keeps the whole tree's
// activations in its shared memory, (N+1) rows ping-ponged between two
// buffers; row N stays zero and is what a child index outside [0, N) reads
// (the one-hot form gives a zero row too). At the start each block copies
// its slice of all three layers' weights (31 KB at F=26, H=96) into shared
// memory with asynchronous copies that overlap the input loads. After each
// of layers 1 and 2 the blocks synchronise across the cluster and each one
// gathers the other blocks' channel slices through distributed shared
// memory; layer 3 needs only its own slice for the pool. Thread (i, g) owns
// channel c0+i and nodes g and g+32, keeping three fp32 accumulators per
// node (self, left, right terms) so the FMA chains overlap; 4 consecutive
// inputs come in one float4 shared-memory load. Plain fp32 FMAs, no tensor
// cores, no TF32.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                      // blocks per tree
constexpr int kGroups = 32;                      // node groups per block
constexpr int kMaxNodes = 64;
constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = kGroups * kMaxHidden / kCluster;   // 512

struct Layer {
  const float* wr;   // (din, H), used as x @ W
  const float* wl;
  const float* wt;
  const float* b;    // (H,)
};

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// Row stride in floats: a multiple of 4 (float4 loads) that is not a
// multiple of 32, so the rows one warp's node groups read start in
// different banks.
__host__ __device__ constexpr int row_ld(int d) {
  return (pad4(d) % 32 == 0) ? pad4(d) + 4 : pad4(d);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Split cluster barrier: arrive (release) now, wait (acquire) later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Start copying this block's slice of one layer's weights into shared
// memory: ws[(m*din + k)*Hc + i] = W_m[k, c0 + i], m over (wr, wl, wrt).
__device__ __forceinline__ void stage(float* ws, const Layer p, int din,
                                      int H, int Hc, int c0, bool vec,
                                      int tid, int nthreads) {
  const int w = vec ? 4 : 1;                     // floats per copy
  const int q = Hc / w, n = 3 * din * q;
  for (int x = tid; x < n; x += nthreads) {
    const int row = x / q, v = x - row * q;      // row = m*din + k
    const int m = row / din, k = row - m * din;
    const int c = c0 + w * v;
    if (c < H) {
      const float* src = (m == 0 ? p.wr : m == 1 ? p.wl : p.wt) + k * H + c;
      __pipeline_memcpy_async(ws + row * Hc + w * v, src, w * sizeof(float));
    }
  }
}

// This block's channel slice of one tree-conv layer: hin (N+1 rows of din,
// stride row_ld(din)) -> hout columns c (rows < N, stride ld_out).
template <int NPT>
__device__ __forceinline__ void conv_slice(
    const float* __restrict__ hin, int din, float* __restrict__ hout,
    int ld_out, const float* __restrict__ ws, int Hc,
    const int* __restrict__ lch, const int* __restrict__ rch,
    const float* __restrict__ msk, float bias, int N, int i, int c, int g,
    bool residual) {
  const int ld_in = row_ld(din);
  const float* w_r = ws + i;
  const float* w_l = ws + din * Hc + i;
  const float* w_t = ws + 2 * din * Hc + i;
  float as[NPT], al[NPT], ar[NPT];
  int self_off[NPT], left_off[NPT], right_off[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = g + j * kGroups;
    const bool live = n < N;                     // idle slots read row N
    as[j] = al[j] = ar[j] = 0.f;
    self_off[j] = (live ? n : N) * ld_in;
    left_off[j] = (live ? lch[n] : N) * ld_in;
    right_off[j] = (live ? rch[n] : N) * ld_in;
  }
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= din; k += 4) {
    float wr[4], wl[4], wt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wr[q] = w_r[(k + q) * Hc];
      wl[q] = w_l[(k + q) * Hc];
      wt[q] = w_t[(k + q) * Hc];
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const float4 s = ld4(hin + self_off[j] + k);
      const float4 l = ld4(hin + left_off[j] + k);
      const float4 r = ld4(hin + right_off[j] + k);
      float a = as[j], b = al[j], d = ar[j];
      a = fmaf(s.x, wr[0], a); b = fmaf(l.x, wl[0], b); d = fmaf(r.x, wt[0], d);
      a = fmaf(s.y, wr[1], a); b = fmaf(l.y, wl[1], b); d = fmaf(r.y, wt[1], d);
      a = fmaf(s.z, wr[2], a); b = fmaf(l.z, wl[2], b); d = fmaf(r.z, wt[2], d);
      a = fmaf(s.w, wr[3], a); b = fmaf(l.w, wl[3], b); d = fmaf(r.w, wt[3], d);
      as[j] = a; al[j] = b; ar[j] = d;
    }
  }
  for (; k < din; ++k) {                         // din % 4 leftover inputs
    const float wr = w_r[k * Hc], wl = w_l[k * Hc], wt = w_t[k * Hc];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      as[j] = fmaf(hin[self_off[j] + k], wr, as[j]);
      al[j] = fmaf(hin[left_off[j] + k], wl, al[j]);
      ar[j] = fmaf(hin[right_off[j] + k], wt, ar[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = g + j * kGroups;
    if (n < N) {
      float v = as[j] + al[j] + ar[j] + bias;
      v = (v > 0.f ? v : 0.01f * v) * msk[n];
      if (residual) v += hin[n * ld_in + c];     // din == H on layer 3
      hout[n * ld_out + c] = v;
    }
  }
}

// Copy the other blocks' channel slices of `buf` (rows < N) into this
// block's copy, W floats at a time; all loads of a batch are issued before
// any of its stores.
template <int W>
__device__ __forceinline__ void gather_slices(cg::cluster_group& cluster,
                                              float* buf, int ld, int N,
                                              int H, int Hc, int rank,
                                              int tid, int nthreads) {
  using V = typename std::conditional<W == 4, float4, float>::type;
  constexpr int kBatch = 4;
  const int q = Hc / W, per = N * q, total = (kCluster - 1) * per;
  for (int base = tid; base < total; base += kBatch * nthreads) {
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

size_t smem_bytes(int N, int F, int H) {
  const int Hc = (H + kCluster - 1) / kCluster;
  const int D = row_ld(F) > row_ld(H) ? row_ld(F) : row_ld(H);
  return sizeof(float) * (2 * static_cast<size_t>(N + 1) * D +
                          3 * static_cast<size_t>(Hc) * (F + 2 * H)) +
         sizeof(int) * 3 * static_cast<size_t>(N);
}

template <int NPT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kMaxThreads) tree_cnn_fused_kernel(
        const float* __restrict__ feat, const int* __restrict__ left,
        const int* __restrict__ right, const float* __restrict__ mask,
        const Layer l1, const Layer l2, const Layer l3,
        float* __restrict__ out, int N, int F, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];              // 16-byte aligned
  const int Hc = (H + kCluster - 1) / kCluster;
  const int ldf = row_ld(F), ldh = row_ld(H);
  const int D = ldf > ldh ? ldf : ldh;
  float* buf_a = reinterpret_cast<float*>(smem4);  // (N+1) x D
  float* buf_b = buf_a + (N + 1) * D;              // (N+1) x D
  float* w1 = buf_b + (N + 1) * D;                 // 3F x Hc
  float* w2 = w1 + 3 * F * Hc;                     // 3H x Hc
  float* w3 = w2 + 3 * H * Hc;                     // 3H x Hc
  int* lch = reinterpret_cast<int*>(w3 + 3 * H * Hc);
  int* rch = lch + N;
  float* msk = reinterpret_cast<float*>(rch + N);

  const int rank = static_cast<int>(cluster.block_rank());
  const int tree = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int c0 = rank * Hc;
  const size_t row0 = static_cast<size_t>(tree) * N;
  const bool vec = Hc % 4 == 0 && H % 4 == 0 &&
                   aligned16(l1.wr) && aligned16(l1.wl) && aligned16(l1.wt) &&
                   aligned16(l2.wr) && aligned16(l2.wl) && aligned16(l2.wt) &&
                   aligned16(l3.wr) && aligned16(l3.wl) && aligned16(l3.wt);

  stage(w1, l1, F, H, Hc, c0, vec, tid, nthreads);
  stage(w2, l2, H, H, Hc, c0, vec, tid, nthreads);
  stage(w3, l3, H, H, Hc, c0, vec, tid, nthreads);
  __pipeline_commit();

  for (int n = tid; n < N; n += nthreads) {
    const int l = left[row0 + n];
    const int r = right[row0 + n];
    lch[n] = (l >= 0 && l < N) ? l : N;
    rch[n] = (r >= 0 && r < N) ? r : N;
    msk[n] = mask[row0 + n];
  }
  const float* ft = feat + row0 * F;
  for (int x = tid; x < N * F; x += nthreads) {
    const int n = x / F;
    buf_a[n * ldf + (x - n * F)] = ft[x] * __ldg(mask + row0 + n);
  }
  for (int x = tid; x < F; x += nthreads) buf_a[N * ldf + x] = 0.f;
  for (int x = tid; x < H; x += nthreads) buf_b[N * ldh + x] = 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  const int i = tid % Hc, g = tid / Hc, c = c0 + i;
  const bool active = c < H && g < kGroups;
  const float b1 = active ? __ldg(l1.b + c) : 0.f;
  const float b2 = active ? __ldg(l2.b + c) : 0.f;
  const float b3 = active ? __ldg(l3.b + c) : 0.f;
  const bool vec_gather = Hc % 4 == 0 && H % 4 == 0;

  if (active)
    conv_slice<NPT>(buf_a, F, buf_b, ldh, w1, Hc, lch, rch, msk, b1, N, i, c,
                    g, false);
  cluster.sync();                                // every slice of h1 written
  if (vec_gather)
    gather_slices<4>(cluster, buf_b, ldh, N, H, Hc, rank, tid, nthreads);
  else
    gather_slices<1>(cluster, buf_b, ldh, N, H, Hc, rank, tid, nthreads);
  for (int x = tid; x < H; x += nthreads) buf_a[N * ldh + x] = 0.f;
  __syncthreads();
  if (active)
    conv_slice<NPT>(buf_b, H, buf_a, ldh, w2, Hc, lch, rch, msk, b2, N, i, c,
                    g, false);
  cluster.sync();                                // h2 written, h1 gathers done
  if (vec_gather)
    gather_slices<4>(cluster, buf_a, ldh, N, H, Hc, rank, tid, nthreads);
  else
    gather_slices<1>(cluster, buf_a, ldh, N, H, Hc, rank, tid, nthreads);
  cluster_arrive();                              // done reading the others
  __syncthreads();
  if (active)
    conv_slice<NPT>(buf_a, H, buf_b, ldh, w3, Hc, lch, rch, msk, b3, N, i, c,
                    g, true);
  __syncthreads();
  if (tid < Hc && c0 + tid < H) {
    const int cc = c0 + tid;
    float m = -INFINITY;
    for (int n = 0; n < N; ++n)
      if (msk[n] > 0.f) m = fmaxf(m, buf_b[n * ldh + cc]);
    out[static_cast<size_t>(tree) * H + cc] = isfinite(m) ? m : 0.f;
  }
  cluster_wait();                                // no block leaves while
                                                 // another may still read it
}

template <int NPT>
cudaError_t launch(const float* feat, const int* left, const int* right,
                   const float* mask, const Layer& l1, const Layer& l2,
                   const Layer& l3, float* out, int B, int N, int F, int H,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, F, H);
  static size_t opted_in = 48 * 1024;            // per instantiation
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_cnn_fused_kernel<NPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const int Hc = (H + kCluster - 1) / kCluster;
  tree_cnn_fused_kernel<NPT><<<B * kCluster, Hc * kGroups, smem, stream>>>(
      feat, left, right, mask, l1, l2, l3, out, N, F, H);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int tree_cnn_fused_forward(
    const float* feat, const int* left, const int* right, const float* mask,
    const float* w1r, const float* w1l, const float* w1t, const float* b1,
    const float* w2r, const float* w2l, const float* w2t, const float* b2,
    const float* w3r, const float* w3l, const float* w3t, const float* b3,
    float* out, int B, int N, int F, int H, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || N < 1 || N > kMaxNodes || F < 1 || H < 1 || H > kMaxHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layer l1{w1r, w1l, w1t, b1}, l2{w2r, w2l, w2t, b2},
      l3{w3r, w3l, w3t, b3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      N <= kGroups
          ? launch<1>(feat, left, right, mask, l1, l2, l3, out, B, N, F, H, s)
          : launch<2>(feat, left, right, mask, l1, l2, l3, out, B, N, F, H, s);
  return static_cast<int>(e);
}
