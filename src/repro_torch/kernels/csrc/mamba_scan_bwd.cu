// Mamba-1 selective scan backward for Hopper (sm_90a), fp32.
//
// The backward of csrc/mamba_scan.cu's function. The reference's Pallas
// kernel (repro/kernels/mamba_scan.py::mamba_scan) has no VJP: the
// reference trains through jnp autodiff of its lax.scan oracle, so this
// kernel replaces that autodiff; its plain version is
// ref.mamba_scan_bwd_ref. Per batch row b and channel d, with
// a_t = exp(dt_t A[d]) and h_t = a_t h_{t-1} + (dt_t x_t) B_t from h0 (or
// zeros), y_t = sum_n C_t[n] h_t[n] + x_t D[d], and the cotangents gy of y
// and gh of h_last = h_{S-1} (either may be null: zero), a reverse loop in
// time carries dh (from gh) back:
//   dh += gy_t C_t;  dC_t += gy_t h_t;  dB_t += dh (dt_t x_t);
//   u = sum_n dh B_t;  g = dh h_{t-1} a_t;  w = sum_n g A;  dA += g dt_t;
//   dx_t = u dt_t + gy_t D;  ddt_t = u x_t + w;  dD += gy_t x_t;  dh *= a_t
// and dh0 = dh at the end. x/dt/gy/dx/ddt (B, S, di), A/dA (di, N),
// Bs/Cs/dB/dC (B, S, N), D/dD (di,), h0/gh/dh0 (B, di, N).
//
// Bound on an H100: device memory and the special-function units. At
// falcon-mamba-7b's train shape (B 2, S 512, di 8192, N 16) the function
// reads x, dt and gy and writes dx and ddt, 168 MB, 0.050 ms at 3.35 TB/s;
// it needs one exp a (b, t, d, n), 134M, 0.032 ms at 16 a clock on each
// SM. This kernel takes two exps a (b, t, d, n) (the forward pass that
// keeps the chunk boundaries, the recompute of each chunk), and reads x,
// dt and B three times (the two forward walks and the reverse one), C and
// gy once, mostly from L2.
//
// Design: the forward kernel's layout, time reversed, no atomics,
// repeatable bit for bit.
// - Each channel's N states are split over L lanes, P = N / L states each
//   (lanes_for, as in the forward kernel); a block owns kCh = 32 channels
//   of one batch row: 256 threads at N = 16.
// - A forward pass keeps h before every chunk of kT = 16 steps in a
//   scratch (B, chunks, di, N). Then the chunks are walked last first:
//   each recomputes its kT + 1 states and kT decays in registers from its
//   boundary state, rounded op by op as the forward kernel rounds them
//   (expf(fp32(dt A)), then a h and (dt x) B each rounded, then their
//   sum): a channel with dt |A| ~ 1e-3 remembers ~1000 steps, so h must
//   be the forward's own, not a cheaper approximation of it. dh walks the
//   chunk's steps back in registers.
// - The sums over a channel's states (u, w) take a butterfly over its L
//   lanes every step. dx, ddt (lane 0) and dh0 are written per channel;
//   dA and dD are summed per channel over time in registers.
// - dB_t and dC_t sum over the di channels: each step's values are added
//   over the channels of a warp by shuffles, then over the block's warps
//   in shared memory at the end of each chunk, and each block writes its
//   partial sums to a scratch (blocks, 2, B, S, N). dA and dD sum over the
//   batch rows: each block writes its (b, channel) partials to a scratch.
//   A second launch adds the partials in a fixed order.
// - Channels past di (the last block) run on zeros (dt = 0 keeps h = 0),
//   so they add nothing and take part in every shuffle and barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatesPerLane = 2;      // P, clamped below (as the forward)
constexpr int kCh = 32;                // channels per block
constexpr int kT = 16;                 // steps per chunk
constexpr unsigned kFull = 0xffffffffu;

// Lanes per channel for N states: N / kStatesPerLane within [4, 16].
constexpr int lanes_for(int n) {
  return n / kStatesPerLane < 4 ? 4 : n / kStatesPerLane > 16
                                          ? 16
                                          : n / kStatesPerLane;
}

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bs;
  const float* Cs;
  const float* D;                      // may be null
  const float* h0;                     // may be null
  const float* gy;                     // may be null
  const float* gh;                     // may be null
  float* dx;
  float* ddt;
  float* dh0;                          // written when h0 is given
  float* states;                       // (B, chunks, di, N)
  float* part_bc;                      // (blocks, 2, B, S, N)
  float* part_ad;                      // (B, di * N + di)
  int B, S, di;
};

template <int L, int P>
struct Layout {
  static constexpr int N = L * P;
  static constexpr int kThreads = kCh * L;
  static constexpr int kWarps = kThreads / 32;
  static constexpr size_t kSmem = sizeof(float) * 2 * kWarps * kT * N;
};

template <int L, int P>
__global__ void __launch_bounds__(Layout<L, P>::kThreads)
    scan_bwd_kernel(const Args a) {
  using Lay = Layout<L, P>;
  constexpr int N = Lay::N, W = Lay::kWarps;
  extern __shared__ float red[];                 // [2][W][kT][N]

  const int tid = threadIdx.x, ch = tid / L, lane = tid % L;
  const int warp = tid / 32;
  const int b = blockIdx.y, d = blockIdx.x * kCh + ch;
  const bool live = d < a.di;
  const int S = a.S, di = a.di;
  const int chunks = (S + kT - 1) / kT;
  const size_t chan = static_cast<size_t>(b) * S * di + d;   // (b, 0, d)
  const size_t hoff = (static_cast<size_t>(b) * di + d) * N + lane * P;
  const float* const Bb = a.Bs + static_cast<size_t>(b) * S * N + lane * P;
  const float* const Cb = a.Cs + static_cast<size_t>(b) * S * N + lane * P;

  auto at = [&](const float* t_, int t) {        // (b, t, d) of x/dt/gy
    return live ? __ldg(t_ + chan + static_cast<size_t>(t) * di) : 0.f;
  };

  float Av[P], h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    Av[j] = live ? __ldg(a.A + static_cast<size_t>(d) * N + lane * P + j)
                 : 0.f;
    h[j] = (live && a.h0 != nullptr) ? __ldg(a.h0 + hoff + j) : 0.f;
  }
  // the state before chunk c of this lane's states
  auto state = [&](int c) {
    return a.states + (static_cast<size_t>(b) * chunks + c) * di * N +
           static_cast<size_t>(d) * N + lane * P;
  };
  // one step of the recurrence, rounded as the forward kernel rounds it;
  // returns the decays in `dec`
  auto step = [&](int t, float (&hv)[P], const float (&hp)[P],
                  float (&dec)[P]) {
    const float dtv = at(a.dt, t), xv = at(a.x, t);
    const float dxv = dtv * xv;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      dec[j] = expf(__fmul_rn(dtv, Av[j]));
      hv[j] = __fadd_rn(__fmul_rn(dec[j], hp[j]),
                        __fmul_rn(dxv, __ldg(Bb + static_cast<size_t>(t) * N +
                                             j)));
    }
  };

  // forward: keep the state before every chunk
  for (int c = 0; c < chunks; ++c) {
    if (live) {
      float* st = state(c);
#pragma unroll
      for (int j = 0; j < P; ++j) st[j] = h[j];
    }
    const int t1 = min(S, (c + 1) * kT);
    for (int t = c * kT; t < t1; ++t) {
      float dec[P], hn[P];
      step(t, hn, h, dec);
#pragma unroll
      for (int j = 0; j < P; ++j) h[j] = hn[j];
    }
  }

  // reverse: chunks last first
  const float Dd = (live && a.D != nullptr) ? __ldg(a.D + d) : 0.f;
  float dh[P], dA[P], dD = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    dh[j] = (live && a.gh != nullptr) ? __ldg(a.gh + hoff + j) : 0.f;
    dA[j] = 0.f;
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kT;
    float hs[kT + 1][P], av[kT][P];              // h_{t0-1+i}, a_{t0+i}
    {
      const float* st = state(c);
#pragma unroll
      for (int j = 0; j < P; ++j) hs[0][j] = live ? st[j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (t0 + i < S) {
        step(t0 + i, hs[i + 1], hs[i], av[i]);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          hs[i + 1][j] = hs[i][j];
          av[i][j] = 1.f;
        }
      }
    }
#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      const int t = t0 + i;
      if (t >= S) continue;                      // the same for every thread
      const float gyv = a.gy != nullptr ? at(a.gy, t) : 0.f;
      const float dtv = at(a.dt, t), xv = at(a.x, t);
      const float dxv = dtv * xv;
      float db[P], dc[P], u = 0.f, w = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float bv = __ldg(Bb + static_cast<size_t>(t) * N + j);
        const float cv = __ldg(Cb + static_cast<size_t>(t) * N + j);
        dh[j] = fmaf(gyv, cv, dh[j]);
        dc[j] = gyv * hs[i + 1][j];
        db[j] = dh[j] * dxv;
        u = fmaf(dh[j], bv, u);
        const float g = dh[j] * hs[i][j] * av[i][j];
        w = fmaf(g, Av[j], w);
        dA[j] = fmaf(g, dtv, dA[j]);
        dh[j] *= av[i][j];
      }
#pragma unroll
      for (int m = 1; m < L; m <<= 1) {          // over the channel's lanes
        u += __shfl_xor_sync(kFull, u, m);
        w += __shfl_xor_sync(kFull, w, m);
      }
      if (lane == 0 && live) {
        const size_t o = chan + static_cast<size_t>(t) * di;
        a.dx[o] = fmaf(gyv, Dd, u * dtv);
        a.ddt[o] = fmaf(u, xv, w);
        dD = fmaf(gyv, xv, dD);
      }
#pragma unroll
      for (int m = L; m < 32; m <<= 1) {         // over the warp's channels
#pragma unroll
        for (int j = 0; j < P; ++j) {
          db[j] += __shfl_xor_sync(kFull, db[j], m);
          dc[j] += __shfl_xor_sync(kFull, dc[j], m);
        }
      }
      if ((tid & 31) < L) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          red[((0 * W + warp) * kT + i) * N + lane * P + j] = db[j];
          red[((1 * W + warp) * kT + i) * N + lane * P + j] = dc[j];
        }
      }
    }
    __syncthreads();
    // the block's sums over its warps, in warp order, for the chunk's steps
    for (int e = tid; e < 2 * kT * N; e += Lay::kThreads) {
      const int which = e / (kT * N), i = (e / N) % kT, n = e % N;
      if (t0 + i >= S) continue;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < W; ++v) s += red[((which * W + v) * kT + i) * N + n];
      a.part_bc[(((static_cast<size_t>(blockIdx.x) * 2 + which) * a.B + b) *
                     S +
                 t0 + i) *
                    N +
                n] = s;
    }
    __syncthreads();
  }

  if (live) {
    float* pa = a.part_ad + static_cast<size_t>(b) * (di * N + di);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pa[static_cast<size_t>(d) * N + lane * P + j] = dA[j];
      if (a.h0 != nullptr) a.dh0[hoff + j] = dh[j];
    }
    if (lane == 0) pa[static_cast<size_t>(di) * N + d] = dD;
  }
}

// dB and dC: the blocks' partials added in block order; dA and dD: the
// batch rows' partials added in row order.
__global__ void scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                    const float* __restrict__ part_ad,
                                    float* __restrict__ dB,
                                    float* __restrict__ dC,
                                    float* __restrict__ dA,
                                    float* __restrict__ dD, int blocks, int B,
                                    int S, int di, int N) {
  const size_t bsn = static_cast<size_t>(B) * S * N;
  const size_t n_a = static_cast<size_t>(di) * N;
  const size_t total = 2 * bsn + n_a + (dD != nullptr ? di : 0);
  const size_t row = n_a + di;                   // a batch row of part_ad
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (e < 2 * bsn) {
      const size_t which = e / bsn, r = e % bsn;
      for (int k = 0; k < blocks; ++k)
        s += part_bc[(static_cast<size_t>(k) * 2 + which) * bsn + r];
      (which ? dC : dB)[r] = s;
    } else {
      const size_t r = e - 2 * bsn;              // dA's, then dD's
      for (int k = 0; k < B; ++k) s += part_ad[k * row + r];
      if (r < n_a)
        dA[r] = s;
      else
        dD[r - n_a] = s;
    }
  }
}

template <int L, int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Lay = Layout<L, P>;
  static bool opted = false;
  if (!opted && Lay::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Lay::kSmem));
    if (e != cudaSuccess) return e;
  }
  opted = true;
  const dim3 grid((a.di + kCh - 1) / kCh, a.B);
  scan_bwd_kernel<L, P><<<grid, Lay::kThreads, Lay::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const Args& a, cudaStream_t stream) {
  constexpr int L = lanes_for(N);
  return launch<L, N / L>(a, stream);
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous float32 tensors: the forward's inputs x, dt, A, Bs, Cs, D
// (may be null: no skip term) and h0 (may be null: zeros); the
// cotangents gy (B, S, di) and gh (B, di, N), each may be null (zero);
// the gradients dx, ddt, dA, dB, dC, dD (null when D is) and dh0 (null
// when h0 is); scratch: states (B, ceil(S / 16), di, N), part_bc
// (ceil(di / 32), 2, B, S, N) and part_ad (B, di * N + di). N must be 4,
// 8, 16 or 32, S at least 1; `stream` is a cudaStream_t. Launches the
// reverse scan, then the kernel that adds the partial sums. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int mamba_scan_backward(
    const float* x, const float* dt, const float* A, const float* Bs,
    const float* Cs, const float* D, const float* h0, const float* gy,
    const float* gh, float* dx, float* ddt, float* dA, float* dB, float* dC,
    float* dD, float* dh0, float* states, float* part_bc, float* part_ad,
    int B, int S, int di, int N, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || di < 0 ||
      (h0 != nullptr && dh0 == nullptr) || (D != nullptr && dD == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,  dt,  A,   Bs,     Cs,      D,       h0, gy, gh,
               dx, ddt, dh0, states, part_bc, part_ad, B,  S,  di};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (B > 0 && di > 0) {
    switch (N) {
      case 4: e = launch_n<4>(a, s); break;
      case 8: e = launch_n<8>(a, s); break;
      case 16: e = launch_n<16>(a, s); break;
      case 32: e = launch_n<32>(a, s); break;
      default: e = cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (N != 4 && N != 8 && N != 16 && N != 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total = 2 * static_cast<size_t>(B) * S * N +
                       static_cast<size_t>(di) * N + (D != nullptr ? di : 0);
  if (total == 0) return 0;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  scan_bwd_sum_kernel<<<blocks, threads, 0, s>>>(
      part_bc, part_ad, dB, dC, dA, D != nullptr ? dD : nullptr,
      (di + kCh - 1) / kCh, B, S, di, N);
  return static_cast<int>(cudaGetLastError());
}
