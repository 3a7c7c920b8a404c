// Mamba-1 selective scan for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (_kernel). Per batch row b and channel d, from h_{-1} = h0 (zeros when
// the h0 pointer is null):
//   h_t = exp(dt_t A[d]) * h_{t-1} + (dt_t x_t) B_t,  y_t = sum_n C_t[n] h_t[n]
// x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N) -> y (B, S, di). With a D
// pointer (di,) the kernel also folds in the Mamba block's skip,
// y_t + x_t * D[d] (ops.selective_scan_fused); with a null one it computes
// the Pallas kernel's function alone. It also writes h_last (B, di, N),
// the state after the last step, which a Mamba prefill keeps for decoding
// (the Pallas kernel returns only y; the reference's model takes h_last
// from its jnp scan).
//
// Bound on an H100: at falcon-mamba-7b's widths (B=1, S=2048, di=8192,
// N=16) a call reads x and dt and writes y, 201 MB, 0.060 ms at 3.35 TB/s.
// Its 268M exps are a second floor: the special-function units return 16
// a clock on each SM, 0.064 ms at 1.98 GHz. The ~1.1 GFLOP of FMAs around
// them take half that. The recurrence runs sequentially in time, in fp32,
// as the TPU kernel's does: no cumulative-product trick, which underflows
// for A < 0.
//
// Design: fill the SMs and keep every step's work beside its exp. Each exp
// costs about a dozen more instructions (expf's range reduction, the
// rounded h update, the partial sum), so the SMs' instruction dispatch,
// not the exps' units or memory, is what bounds this kernel.
// - Each channel's N states are split over L lanes, P = N / L states each
//   (kStatesPerLane picks L), so the card holds B*di*L threads: 2048 warps
//   at falcon-mamba-7b, 16 on each SM, each with P independent chains.
//   Measured against 4 lanes x 4 states (8 warps an SM, fewer shuffles) and
//   16 x 1 (32 warps, more loads and shuffles an exp): 8 x 2 is fastest.
// - Each step's decay is expf(fp32(dt A)) and h = a h + b is rounded op
//   by op, as the plain version computes them, so that h is the plain
//   version's own. A channel with dt |A| ~ 1e-3 remembers ~1000 steps, so
//   a per-step error in the decay adds up: with ex2.approx for the decay
//   and a fused h update, S = 2048 took 9.3e-4 against the 1e-4 limit.
//   Only the order of the sums over the states (below) differs from the
//   plain version.
// - y_t is not reduced over the lanes at every step. Each lane keeps its
//   partial sums of L steps in registers, and one reduce-scatter over the
//   L lanes (L - 1 shuffles) leaves lane l with the total of step l.
// - A block owns kCh = 32 channels of one batch row and walks time in
//   chunks of kT steps. Each chunk's x and dt (transposed to channel-major)
//   and B_t, C_t (state-major) arrive by 4-byte cp.async in a ring of
//   kStages buffers, two chunks ahead, so that a lane reads four steps of
//   each in one 16-byte shared-memory load. One barrier a chunk (64-step
//   chunks on 3 buffers measured slower).
// - y goes back through shared memory, a chunk at a time, in coalesced
//   128-byte rows, with the skip term added there from the staged x.
// - h0 and h_last are each lane's own P states, read into the h[P]
//   registers before the time loop and written from them after it: 2 x
//   4 MB at falcon-mamba-7b's prefill (B = 8), against 268 MB of x, dt and
//   y. Steps past S in the last chunk are zero-filled, so dt = 0 there and
//   h passes them unchanged (exp(0) h + 0).
// - For training, an optional `states` pointer (B, ceil(S / 16), di, N):
//   each lane writes its P states of h before every kStateT = 16th step,
//   the chunk boundaries from which the backward kernel
//   (csrc/mamba_scan_bwd.cu) recomputes each chunk, so that it takes no
//   forward walk of its own. They are the forward's own h, rounded as
//   above, bit for bit. 33.5 MB at falcon-mamba-7b's train shape (B 2, S
//   512), written 256 bytes a warp; the serving path passes null and
//   writes nothing more.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatesPerLane = 2;      // the design knob: P, clamped below
constexpr int kCh = 32;                // channels per block
constexpr int kT = 32;                 // time steps per chunk
constexpr int kStages = 4;             // chunk buffers: 2 ahead, 1 in the
                                       // scan, 1 in the write-back
constexpr int kXld = kT + 4;           // row stride of a staged row of steps
constexpr int kStateT = 16;            // steps between the states kept for
                                       // the backward (its chunk, kT there)
constexpr unsigned kFull = 0xffffffffu;

// Lanes per channel for N states: N / kStatesPerLane within [4, 16].
constexpr int lanes_for(int n) {
  return n / kStatesPerLane < 4 ? 4 : n / kStatesPerLane > 16
                                          ? 16
                                          : n / kStatesPerLane;
}

// Stride between the lanes' blocks of P state rows in the B/C buffers:
// the L rows a warp reads at once start in distinct 16-byte bank groups.
constexpr int lane_stride(int p) {
  return p * kXld + ((4 - p * kXld) % 32 + 32) % 32;
}

template <int L, int P>
struct Layout {
  static constexpr int N = L * P;
  static constexpr int kThreads = kCh * L;
  static constexpr int kLs = lane_stride(P);
  static constexpr int kYld = kCh + 32 / L;     // ys row stride: the L
                                                // lanes' stores miss banks
  static constexpr int kXBuf = kCh * kXld;      // one chunk of x (or dt)
  static constexpr int kBBuf = L * kLs;         // one chunk of B (or C)
  static constexpr int kYBuf = kT * kYld;       // one chunk of y
  static constexpr int kFloats = kStages * (2 * kXBuf + 2 * kBBuf)
                                 + 2 * kYBuf;
};

// 4-byte asynchronous copy to shared memory; zero-fills (and reads
// nothing) when !ok.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <int L, int P>
__global__ void __launch_bounds__(Layout<L, P>::kThreads,
                                  Layout<L, P>::kThreads < 512 ? 2 : 1)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bs,
                  const float* __restrict__ Cs, const float* __restrict__ D,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, float* __restrict__ states,
                  int S, int di) {
  using Lay = Layout<L, P>;
  constexpr int N = Lay::N, T = Lay::kThreads;
  constexpr int kRows = T / kCh;                 // x rows a pass copies
  constexpr int kXPer = kT / kRows;              // x (and dt) copies a thread
  constexpr int kBRows = T / N;                  // B rows a pass copies
  static_assert(T % kCh == 0 && kT % kRows == 0 && T % N == 0 &&
                    kT % kBRows == 0 && kT % L == 0 && L % 4 == 0 &&
                    kT % kStateT == 0 && kStateT % L == 0,
                "the copy and scan loops take whole passes");
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);  // [stage][ch][t]
  float* const ds = xs + kStages * Lay::kXBuf;         // [stage][ch][t]
  float* const bs = ds + kStages * Lay::kXBuf;         // [stage][lane][j][t]
  float* const cs = bs + kStages * Lay::kBBuf;
  float* const ys = cs + kStages * Lay::kBBuf;         // [2][t][ch]

  const int tid = threadIdx.x;
  const int ch = tid / L, lane = tid % L;        // lane in its channel
  const int d0 = blockIdx.x * kCh;
  const int chunks = (S + kT - 1) / kT;

  // this lane's P states of channel d0 + ch in A, h0 and h_last
  const bool live = d0 + ch < di;
  const size_t hoff =
      (static_cast<size_t>(blockIdx.y) * di + d0 + ch) * N + lane * P;
  // this lane's P states before step 0 of the states' chunk sc:
  // states (B, ceil(S / kStateT), di, N)
  const int schunks = (S + kStateT - 1) / kStateT;
  float* const sp = states == nullptr ? nullptr
                    : states + (static_cast<size_t>(blockIdx.y) * schunks *
                                    di + d0 + ch) * N + lane * P;
  float a[P], h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    a[j] = live
               ? __ldg(A + static_cast<size_t>(d0 + ch) * N + lane * P + j)
               : 0.f;
    h[j] = (live && h0 != nullptr) ? __ldg(h0 + hoff + j) : 0.f;
  }

  // Per-thread constants of the copies and the write-back: thread tid
  // moves column xcol of x/dt/y rows xrow + i * kRows of each chunk, and
  // state bn of B/C rows brow + i * kBRows. The pointers walk one chunk a
  // load; a copy past the end reads nothing and zero-fills.
  const int xcol = tid % kCh, xrow = tid / kCh;
  const bool xok = d0 + xcol < di;
  const size_t xoff = static_cast<size_t>(blockIdx.y) * S * di
                      + static_cast<size_t>(xrow) * di + d0 + xcol;
  const size_t xstep = static_cast<size_t>(kRows) * di;
  const float* xp = x + xoff;
  const float* dp = dt + xoff;
  const int bn = tid % N, brow = tid / N;
  const size_t boff = (static_cast<size_t>(blockIdx.y) * S + brow) * N + bn;
  const float* bp = Bs + boff;
  const float* cp = Cs + boff;
  const int bdst = (bn / P) * Lay::kLs + (bn % P) * kXld + brow;

  auto load = [&](int c) {                       // chunk c into its buffer
    const int t0 = c * kT, s = c % kStages;
    float* xb = xs + s * Lay::kXBuf + xcol * kXld + xrow;
    float* db = ds + s * Lay::kXBuf + xcol * kXld + xrow;
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const bool ok = xok && t0 + i * kRows + xrow < S;
      cp4(xb + i * kRows, xp + i * xstep, ok);
      cp4(db + i * kRows, dp + i * xstep, ok);
    }
    float* bb = bs + s * Lay::kBBuf + bdst;
    float* cb = cs + s * Lay::kBBuf + bdst;
#pragma unroll
    for (int i = 0; i < kT / kBRows; ++i) {
      const bool ok = t0 + i * kBRows + brow < S;
      cp4(bb + i * kBRows, bp + i * kBRows * N, ok);
      cp4(cb + i * kBRows, cp + i * kBRows * N, ok);
    }
    xp += kXPer * xstep;
    dp += kXPer * xstep;
    bp += kT * N;
    cp += kT * N;
  };

  float* yp = y + xoff;
  const float dskip = (D != nullptr && xok) ? __ldg(D + d0 + xcol) : 0.f;
  auto write_back = [&](int c) {                 // chunk c's y, coalesced
    const int t0 = c * kT;
    const float* yb = ys + (c & 1) * Lay::kYBuf + xrow * Lay::kYld + xcol;
    const float* xb = xs + (c % kStages) * Lay::kXBuf + xcol * kXld + xrow;
    float* yc = yp + static_cast<size_t>(t0) * di;
    if (!xok) return;
    if (D != nullptr) {
#pragma unroll
      for (int i = 0; i < kXPer; ++i)
        if (t0 + i * kRows + xrow < S)
          yc[i * xstep] = fmaf(xb[i * kRows], dskip, yb[i * kRows * Lay::kYld]);
    } else {
#pragma unroll
      for (int i = 0; i < kXPer; ++i)
        if (t0 + i * kRows + xrow < S)
          yc[i * xstep] = yb[i * kRows * Lay::kYld];
    }
  };

  auto scan = [&](int c) {                       // chunk c's recurrence
    const int s = c % kStages;
    const float* xr = xs + s * Lay::kXBuf + ch * kXld;
    const float* dr = ds + s * Lay::kXBuf + ch * kXld;
    const float* br = bs + s * Lay::kBBuf + lane * Lay::kLs;
    const float* cr = cs + s * Lay::kBBuf + lane * Lay::kLs;
    float* yw = ys + (c & 1) * Lay::kYBuf + ch;
#pragma unroll
    for (int g0 = 0; g0 < kT; g0 += L) {         // groups of L steps
      if (g0 % kStateT == 0 && sp != nullptr && live &&
          c * kT + g0 < S) {                     // h before this step
        float* at = sp + static_cast<size_t>((c * kT + g0) / kStateT) * di * N;
#pragma unroll
        for (int j = 0; j < P; ++j) at[j] = h[j];
      }
      float part[L];                             // this lane's partial y
#pragma unroll
      for (int q = 0; q < L; q += 4) {
        float dtv[4], xv[4], bv[P][4], cv[P][4];
        ld4(dtv, dr + g0 + q);
        ld4(xv, xr + g0 + q);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          ld4(bv[j], br + j * kXld + g0 + q);
          ld4(cv[j], cr + j * kXld + g0 + q);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // h = exp(dt A) h + (dt x) B rounded as the plain version rounds
          // it, op by op, so that h does not drift from it over long
          // memories (dt |A| ~ 1e-3 keeps ~1000 steps)
          const float dx = dtv[i] * xv[i];
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            h[j] = __fadd_rn(__fmul_rn(expf(dtv[i] * a[j]), h[j]),
                             __fmul_rn(dx, bv[j][i]));
            acc = fmaf(h[j], cv[j][i], acc);
          }
          part[q + i] = acc;
        }
      }
      // reduce-scatter over the L lanes: each round halves the values a
      // lane holds, keeping those whose index has the lane's bit m, so
      // lane l ends with the sum over lanes of step g0 + l
#pragma unroll
      for (int m = L / 2; m >= 1; m >>= 1) {
        const bool up = lane & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float send = up ? part[i] : part[i + m];
          const float keep = up ? part[i + m] : part[i];
          part[i] = keep + __shfl_xor_sync(kFull, send, m);
        }
      }
      yw[(g0 + lane) * Lay::kYld] = part[0];
    }
  };

  for (int c = 0; c < kStages - 2; ++c) {
    if (c < chunks) load(c);
    cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kStages - 3>();                      // chunk c has landed
    __syncthreads();                             // ... for every thread, and
                                                 // chunk c-2 is written back
    if (c + kStages - 2 < chunks) load(c + kStages - 2);
    cp_commit();
    if (c > 0) write_back(c - 1);
    scan(c);
  }
  __syncthreads();
  write_back(chunks - 1);
  if (live) {
#pragma unroll
    for (int j = 0; j < P; ++j) h_last[hoff + j] = h[j];
  }
}

template <int L, int P>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bs, const float* Cs, const float* D,
                   const float* h0, float* y, float* h_last, float* states,
                   int B, int S, int di, cudaStream_t stream) {
  using Lay = Layout<L, P>;
  constexpr size_t smem = sizeof(float) * Lay::kFloats;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((di + kCh - 1) / kCh, B);
  mamba_scan_kernel<L, P><<<grid, Lay::kThreads, smem, stream>>>(
      x, dt, A, Bs, Cs, D, h0, y, h_last, states, S, di);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const float* x, const float* dt, const float* A,
                     const float* Bs, const float* Cs, const float* D,
                     const float* h0, float* y, float* h_last, float* states,
                     int B, int S, int di, cudaStream_t stream) {
  constexpr int L = lanes_for(N);
  return launch<L, N / L>(x, dt, A, Bs, Cs, D, h0, y, h_last, states, B, S,
                          di, stream);
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous float32 tensors; D (di,) may be null (no skip term), h0
// (B, di, N) may be null (start from zeros), h_last (B, di, N) may not;
// states (B, ceil(S / 16), di, N) may be null: given, the kernel also
// writes the state before every 16th step there (the backward's chunk
// boundaries; chunk 0's is h0 or zeros). `stream` is a cudaStream_t. N must
// be 4, 8, 16 or 32, S at least 1. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int mamba_scan_forward(const float* x, const float* dt,
                                  const float* A, const float* Bs,
                                  const float* Cs, const float* D,
                                  const float* h0, float* y, float* h_last,
                                  float* states, int B, int S, int di, int N,
                                  void* stream) {
  if (B < 0 || B > 65535 || S < 1 || di < 0 || h_last == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || di == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (N) {
#define MAMBA_SCAN_CASE(n)                                                  \
  case n:                                                                   \
    e = launch_n<n>(x, dt, A, Bs, Cs, D, h0, y, h_last, states, B, S, di,  \
                    s);                                                     \
    break;
    MAMBA_SCAN_CASE(4)
    MAMBA_SCAN_CASE(8)
    MAMBA_SCAN_CASE(16)
    MAMBA_SCAN_CASE(32)
#undef MAMBA_SCAN_CASE
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
