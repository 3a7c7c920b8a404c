// One Neo tree-convolution layer for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/tree_conv.py::tree_conv
// (_kernel). Per tree, with h = feat * mask:
//   out = leaky_relu_0.01(h Wr + h[left] Wl + h[right] Wrt + b) * mask,
// feat (B, N, F) -> out (B, N, H). A child index outside [0, N) reads a
// zero row, as the reference's one-hot form gives.
//
// Bound on an H100: at the AQORA widths (B=8, N<=64, F<=96, H=96) a call
// does at most ~28 MFLOP of FMAs and moves ~0.5 MB, under a microsecond
// at the card's peaks, so latency bounds it: the launch, one round of
// loads into shared memory and one pass of FMAs. The TPU version ships
// (B, N, N) one-hots through device memory and multiplies by them; here
// the children are gathered from shared memory and no one-hot exists.
//
// Design: block (x, y, z) computes tree z's nodes [16y, 16y+16) for output
// channels [32x, 32x+32): 72 to 96 blocks at B = 8.
// - Everything the k loop reads is staged in shared memory first, with
//   every copy in flight at once and one barrier after: the block's slice
//   of the three weight matrices (32 channels x F rows each, 36 KB at
//   F = 96), the tree's N rows of F inputs (16-byte cp.async where the
//   rows allow it) and its mask. Row N stays zero: the null child. Inputs
//   past F are zero too, so the k loop runs in steps of 4 with no tail.
//   Above 128 input features the weights come in tiles of 128 rows.
// - The mask is applied after the sums, not to the staged rows: the
//   self, left and right sums are each scaled by their row's mask
//   (exact for a 0/1 mask; one rounding apart otherwise).
// - Thread (c, g) of 256 owns channel c and nodes g and g + 8. A warp's
//   32 lanes share their nodes and read 32 consecutive channels: an input
//   read is one 16-byte broadcast of 4 k, a weight read one conflict-free
//   row. Three fp32 accumulators per node (self, left, right terms) keep
//   the FMA chains apart. Plain fp32 FMAs, no tensor cores, no TF32.
//   Measured against 4 nodes a thread (128 threads), 1 (512) and 8-node
//   blocks: this tile is fastest, by up to 15%; all sit near the fixed
//   cost of one launch and one round of loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodesPerThread = 2;               // the design knob
constexpr int kCh = 32;                          // channels per block (x)
constexpr int kNodes = 16;                       // nodes per block (y)
constexpr int kGroups = kNodes / kNodesPerThread;  // warps per block
constexpr int kThreads = kCh * kGroups;
constexpr int kKTile = 128;                      // weight rows staged at once
constexpr int kMaxNodes = 64;
constexpr int kMaxFeat = 512;

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int Bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(Bytes) : "memory");
}

// Start copying `rows` rows of `cols` floats (src row stride src_ld) to
// dst (row stride ld), W floats a copy; cols % W == 0.
template <int W>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, size_t src_ld,
                                           int rows, int cols, int tid) {
  const int q = cols / W;
  for (int x = tid; x < rows * q; x += kThreads) {
    const int r = x / q, v = x - r * q;
    cp_async<4 * W>(dst + r * ld + v * W, src + r * src_ld + v * W);
  }
}

__device__ __forceinline__ void stage_any(float* dst, int ld,
                                          const float* src, size_t src_ld,
                                          int rows, int cols, int tid) {
  if (cols % 4 == 0 && src_ld % 4 == 0 && aligned(src, 16))
    stage_rows<4>(dst, ld, src, src_ld, rows, cols, tid);
  else if (cols % 2 == 0 && src_ld % 2 == 0 && aligned(src, 8))
    stage_rows<2>(dst, ld, src, src_ld, rows, cols, tid);
  else
    stage_rows<1>(dst, ld, src, src_ld, rows, cols, tid);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads) tree_conv_kernel(
    const float* __restrict__ feat, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ mask,
    const float* __restrict__ wr, const float* __restrict__ wl,
    const float* __restrict__ wt, const float* __restrict__ bias,
    float* __restrict__ out, int N, int F, int H) {
  const int ld = pad4(F);                        // staged row stride
  const int wrows = min(kKTile, ld);             // weight rows a tile
  extern __shared__ float4 smem4[];
  float* const ws = reinterpret_cast<float*>(smem4);  // [3][wrows][kCh]
  float* const h = ws + 3 * wrows * kCh;              // [N + 1][ld]
  float* const msk = h + (N + 1) * ld;                // [N + 1]

  const int tree = blockIdx.z;
  const size_t row0 = static_cast<size_t>(tree) * N;
  const int tid = threadIdx.y * kCh + threadIdx.x;
  const int c0 = blockIdx.x * kCh, c = c0 + threadIdx.x;
  const int cw = min(kCh, H - c0);               // this block's channels

  int self_row[kNodesPerThread], left_row[kNodesPerThread],
      right_row[kNodesPerThread];
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) {
    const int n = blockIdx.y * kNodes + threadIdx.y + j * kGroups;
    int s = N, l = N, r = N;                     // idle slots read row N
    if (n < N) {
      s = n;
      l = __ldg(left + row0 + n);
      r = __ldg(right + row0 + n);
      l = (l >= 0 && l < N) ? l : N;
      r = (r >= 0 && r < N) ? r : N;
    }
    self_row[j] = s;
    left_row[j] = l;
    right_row[j] = r;
  }

  const float b = c < H ? __ldg(bias + c) : 0.f;
  float as[kNodesPerThread], al[kNodesPerThread], ar[kNodesPerThread];
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) as[j] = al[j] = ar[j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += kKTile) {
    const int kt = min(kKTile, F - k0);
    if (k0 > 0) __syncthreads();                 // the last tile is read
    const size_t at = static_cast<size_t>(k0) * H + c0;
    stage_any(ws, kCh, wr + at, H, kt, cw, tid);
    stage_any(ws + wrows * kCh, kCh, wl + at, H, kt, cw, tid);
    stage_any(ws + 2 * wrows * kCh, kCh, wt + at, H, kt, cw, tid);
    for (int x = tid; x < 3 * (pad4(kt) - kt) * kCh; x += kThreads) {
      const int m = x / ((pad4(kt) - kt) * kCh);
      const int rem = x - m * (pad4(kt) - kt) * kCh;
      ws[(m * wrows + kt + rem / kCh) * kCh + rem % kCh] = 0.f;
    }
    if (k0 == 0) {
      stage_any(h, ld, feat + row0 * F, F, N, F, tid);
      for (int n = tid; n < N; n += kThreads)
        cp_async<4>(msk + n, mask + row0 + n);
      for (int x = tid; x < ld; x += kThreads) h[N * ld + x] = 0.f;
      for (int x = tid; x < N * (ld - F); x += kThreads)
        h[(x / (ld - F)) * ld + F + x % (ld - F)] = 0.f;
      if (tid == 0) msk[N] = 0.f;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const float* w0 = ws + threadIdx.x;
    const float* w1 = w0 + wrows * kCh;
    const float* w2 = w1 + wrows * kCh;
#pragma unroll 2
    for (int k = 0; k < pad4(kt); k += 4) {
      float vr[4], vl[4], vt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = w0[(k + q) * kCh];
        vl[q] = w1[(k + q) * kCh];
        vt[q] = w2[(k + q) * kCh];
      }
#pragma unroll
      for (int j = 0; j < kNodesPerThread; ++j) {
        const float4 s = ld4(h + self_row[j] * ld + k0 + k);
        const float4 l = ld4(h + left_row[j] * ld + k0 + k);
        const float4 r = ld4(h + right_row[j] * ld + k0 + k);
        float a = as[j], b = al[j], d = ar[j];
        a = fmaf(s.x, vr[0], a); b = fmaf(l.x, vl[0], b); d = fmaf(r.x, vt[0], d);
        a = fmaf(s.y, vr[1], a); b = fmaf(l.y, vl[1], b); d = fmaf(r.y, vt[1], d);
        a = fmaf(s.z, vr[2], a); b = fmaf(l.z, vl[2], b); d = fmaf(r.z, vt[2], d);
        a = fmaf(s.w, vr[3], a); b = fmaf(l.w, vl[3], b); d = fmaf(r.w, vt[3], d);
        as[j] = a; al[j] = b; ar[j] = d;
      }
    }
  }
  if (c >= H) return;
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) {
    const int n = self_row[j];
    if (n < N) {
      float v = msk[n] * as[j];
      v = fmaf(msk[left_row[j]], al[j], v);
      v = fmaf(msk[right_row[j]], ar[j], v);
      v += b;
      v = (v > 0.f ? v : 0.01f * v) * msk[n];
      out[(row0 + n) * H + c] = v;
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous float32/int32 tensors; `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tree_conv_forward(const float* feat, const int* left,
                                 const int* right, const float* mask,
                                 const float* wr, const float* wl,
                                 const float* wt, const float* b, float* out,
                                 int B, int N, int F, int H, void* stream) {
  if (B == 0 || N == 0 || H == 0) return 0;
  if (B < 0 || B > 65535 || N < 0 || N > kMaxNodes || F < 1 ||
      F > kMaxFeat || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = pad4(F), wrows = ld < kKTile ? ld : kKTile;
  const size_t smem = sizeof(float) * (static_cast<size_t>(3) * wrows * kCh
                                       + static_cast<size_t>(N + 1) * ld
                                       + (N + 1));
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  const dim3 grid((H + kCh - 1) / kCh, (N + kNodes - 1) / kNodes, B);
  tree_conv_kernel<<<grid, dim3(kCh, kGroups), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      feat, left, right, mask, wr, wl, wt, b, out, N, F, H);
  return static_cast<int>(cudaGetLastError());
}
