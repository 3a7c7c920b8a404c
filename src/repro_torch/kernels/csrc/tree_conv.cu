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
// at the card's peaks, so latency bounds it: the launch and one pass of
// dependent loads and FMAs. The TPU version ships (B, N, N) one-hots
// through device memory and multiplies by them; here the children are
// gathered from shared memory and no one-hot exists.
//
// Design: block (x, y, z) computes tree z's nodes [16y, 16y+16) for output
// channels [32x, 32x+32). It stages the whole masked tree, N+1 rows of F,
// in shared memory (row N stays zero: the null child), so any node's
// children are one shared-memory read away. Thread (c, g) owns channel c
// and nodes g and g+8 of the block's 16, with three fp32 accumulators per
// node (self, left, right terms) so the FMA chains overlap. A warp's 32
// lanes share a node and read 32 consecutive channels: the activation read
// is a shared-memory broadcast and the weight read one coalesced 128-byte
// line from L1/L2. Plain fp32 FMAs, no tensor cores, no TF32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;                    // channels per block (x)
constexpr int kGroups = 8;                       // node groups per block (y)
constexpr int kNodesPerThread = 2;
constexpr int kNodes = kGroups * kNodesPerThread;  // nodes per block
constexpr int kMaxNodes = 64;
constexpr int kMaxFeat = 512;

__global__ void __launch_bounds__(kChannels * kGroups) tree_conv_kernel(
    const float* __restrict__ feat, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ mask,
    const float* __restrict__ wr, const float* __restrict__ wl,
    const float* __restrict__ wt, const float* __restrict__ bias,
    float* __restrict__ out, int N, int F, int H) {
  extern __shared__ float h[];                   // (N + 1) x F
  const int tree = blockIdx.z;
  const size_t row0 = static_cast<size_t>(tree) * N;
  const int tid = threadIdx.y * kChannels + threadIdx.x;
  const int nthreads = kChannels * kGroups;

  const float* ft = feat + row0 * F;
  for (int x = tid; x < N * F; x += nthreads) {
    const int n = x / F;
    h[x] = ft[x] * __ldg(mask + row0 + n);
  }
  for (int x = tid; x < F; x += nthreads) h[N * F + x] = 0.f;

  const int c = blockIdx.x * kChannels + threadIdx.x;
  int self_off[kNodesPerThread], left_off[kNodesPerThread],
      right_off[kNodesPerThread];
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
    self_off[j] = s * F;
    left_off[j] = l * F;
    right_off[j] = r * F;
  }
  __syncthreads();
  if (c >= H) return;

  float as[kNodesPerThread], al[kNodesPerThread], ar[kNodesPerThread];
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) as[j] = al[j] = ar[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    const float w_r = __ldg(wr + static_cast<size_t>(k) * H + c);
    const float w_l = __ldg(wl + static_cast<size_t>(k) * H + c);
    const float w_t = __ldg(wt + static_cast<size_t>(k) * H + c);
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j) {
      as[j] = fmaf(h[self_off[j] + k], w_r, as[j]);
      al[j] = fmaf(h[left_off[j] + k], w_l, al[j]);
      ar[j] = fmaf(h[right_off[j] + k], w_t, ar[j]);
    }
  }
  const float b = __ldg(bias + c);
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) {
    const int n = blockIdx.y * kNodes + threadIdx.y + j * kGroups;
    if (n < N) {
      float v = as[j] + al[j] + ar[j] + b;
      v = (v > 0.f ? v : 0.01f * v) * __ldg(mask + row0 + n);
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
  const size_t smem = sizeof(float) * static_cast<size_t>(N + 1) * F;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  const dim3 grid((H + kChannels - 1) / kChannels, (N + kNodes - 1) / kNodes,
                  B);
  tree_conv_kernel<<<grid, dim3(kChannels, kGroups), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      feat, left, right, mask, wr, wl, wt, b, out, N, F, H);
  return static_cast<int>(cudaGetLastError());
}
