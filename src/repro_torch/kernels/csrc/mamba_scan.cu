// Mamba-1 selective scan for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (_kernel). Per batch row b and channel d, with h = 0 at t = 0:
//   h_t = exp(dt_t A[d]) * h_{t-1} + (dt_t x_t) B_t,  y_t = sum_n C_t[n] h_t[n]
// x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N) -> y (B, S, di). Only y is
// returned, as the Pallas kernel does.
//
// Bound on an H100: at falcon-mamba-7b's widths (B=1, S=2048, di=8192,
// N=16) a call reads x and dt and writes y, 201 MB, 0.06 ms at 3.35 TB/s,
// and does 268M exps and ~1.9 GFLOP, 0.03 ms at the fp32 rate; device
// memory bounds it. The recurrence is sequential in time and runs so, in
// fp32, as the TPU kernel's does: no cumulative-product trick, which
// underflows for A < 0.
//
// Design: parallelism is the trouble. B*di = 8192 channels, one thread
// each, would be 256 warps on 132 SMs. So each channel's N states are
// split over kLanes = 4 neighbouring lanes (N/4 states each, in registers)
// and y_t is summed over the four with two shuffles: 1024 warps, each
// state update independent of the others. A block owns kCh = 64 channels
// of one batch row and walks time in chunks of kT = 32 steps: the chunk's
// x and dt (kT x kCh) and B_t, C_t (kT x N, shared by every channel) are
// staged in shared memory with coalesced loads, the next chunk's loads are
// in flight in registers while this chunk is scanned, and y is written
// back a chunk at a time, coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                        // lanes per channel
constexpr int kCh = 64;                          // channels per block
constexpr int kThreads = kCh * kLanes;           // 256
constexpr int kT = 32;                           // time steps per chunk
constexpr unsigned kFull = 0xffffffffu;

template <int NPL>                               // states per lane
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bs,
    const float* __restrict__ Cs, float* __restrict__ y, int S, int di) {
  constexpr int N = kLanes * NPL;
  constexpr int kXPer = kT * kCh / kThreads;     // x/dt values per thread
  constexpr int kBPer = (kT * N + kThreads - 1) / kThreads;
  __shared__ float xs[kT][kCh], ds[kT][kCh], ys[kT][kCh];
  __shared__ float bs[kT][N], cs[kT][N];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes, n0 = (tid % kLanes) * NPL;
  const int d0 = blockIdx.x * kCh, d = d0 + ch;
  const size_t xbase = static_cast<size_t>(blockIdx.y) * S * di;
  const size_t bbase = static_cast<size_t>(blockIdx.y) * S * N;

  float a[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    a[j] = d < di ? __ldg(A + static_cast<size_t>(d) * N + n0 + j) : 0.f;
    h[j] = 0.f;
  }

  float px[kXPer], pd[kXPer], pb[kBPer], pc[kBPer];
  auto fetch = [&](int t0) {                     // chunk t0 into registers
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads, r = e / kCh, c = e % kCh;
      const bool ok = t0 + r < S && d0 + c < di;
      const size_t at = xbase + static_cast<size_t>(t0 + r) * di + d0 + c;
      px[i] = ok ? __ldg(x + at) : 0.f;
      pd[i] = ok ? __ldg(dt + at) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads, r = e / N;
      const bool ok = e < kT * N && t0 + r < S;
      const size_t at = bbase + static_cast<size_t>(t0) * N + e;
      pb[i] = ok ? __ldg(Bs + at) : 0.f;
      pc[i] = ok ? __ldg(Cs + at) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    __syncthreads();                             // last chunk fully read
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      xs[e / kCh][e % kCh] = px[i];
      ds[e / kCh][e % kCh] = pd[i];
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kT * N) {
        bs[e / N][e % N] = pb[i];
        cs[e / N][e % N] = pc[i];
      }
    }
    __syncthreads();
    if (t0 + kT < S) fetch(t0 + kT);             // in flight during the scan

    const int steps = min(kT, S - t0);
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = ds[t][ch];
      const float dx = dtv * xs[t][ch];
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        h[j] = fmaf(expf(dtv * a[j]), h[j], dx * bs[t][n0 + j]);
        yp = fmaf(h[j], cs[t][n0 + j], yp);
      }
      yp += __shfl_xor_sync(kFull, yp, 1);
      yp += __shfl_xor_sync(kFull, yp, 2);
      if (n0 == 0) ys[t][ch] = yp;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads, r = e / kCh, c = e % kCh;
      if (r < steps && d0 + c < di)
        y[xbase + static_cast<size_t>(t0 + r) * di + d0 + c] = ys[r][c];
    }
  }
}

template <int NPL>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bs, const float* Cs, float* y, int B, int S,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + kCh - 1) / kCh, B);
  mamba_scan_kernel<NPL><<<grid, kThreads, 0, stream>>>(x, dt, A, Bs, Cs, y,
                                                        S, di);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous float32 tensors; `stream` is a cudaStream_t. N must be 4, 8,
// 16 or 32. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mamba_scan_forward(const float* x, const float* dt,
                                  const float* A, const float* Bs,
                                  const float* Cs, float* y, int B, int S,
                                  int di, int N, void* stream) {
  if (B == 0 || S == 0 || di == 0) return 0;
  if (B < 0 || B > 65535 || S < 0 || di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (N) {
    case 4: e = launch<1>(x, dt, A, Bs, Cs, y, B, S, di, s); break;
    case 8: e = launch<2>(x, dt, A, Bs, Cs, y, B, S, di, s); break;
    case 16: e = launch<4>(x, dt, A, Bs, Cs, y, B, S, di, s); break;
    case 32: e = launch<8>(x, dt, A, Bs, Cs, y, B, S, di, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
