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
// Bound on an H100: device memory. At falcon-mamba-7b's train shape (B 2,
// S 512, di 8192, N 16) the function reads x, dt and gy and writes dx and
// ddt, 168 MB, 0.050 ms at 3.35 TB/s; its one exp a (b, t, d, n), 134M,
// takes 0.032 ms at 16 a clock on each SM. This kernel reads besides the
// forward's chunk states (B, S / 16, di, N), 33.5 MB there, and writes
// and reads 8.4 MB of dB/dC partials.
//
// Design: the forward kernel's layout, time reversed, no atomics,
// repeatable bit for bit.
// - Each channel's N states are split over L lanes, P = N / L states each
//   (lanes_for, as in the forward kernel); a block owns kCh = 16 channels
//   of one batch row: 128 threads at N = 16, four blocks an SM (32
//   channels a block, two an SM, measured 7% slower: more warps wait at
//   each block barrier).
// - The chunks of kT = 16 steps are walked last first, each started from
//   the state the forward kernel kept before it (`states`, written by
//   mamba_scan_forward): its kT + 1 states and kT decays are recomputed in
//   registers (hs[17][P], av[16][P]: 66 registers at P = 2), rounded op
//   by op as the forward rounds them (expf(fp32(dt A)), then a h and
//   (dt x) B each rounded, then their sum): a channel with dt |A| ~ 1e-3
//   remembers ~1000 steps, so h must be the forward's own. One exp a
//   state-step. dh walks the chunk's steps back in registers.
// - Each chunk's x, dt, gy (transposed to channel-major) and B_t, C_t
//   (state-major) arrive by 4-byte cp.async in a ring of kStages = 3
//   buffers, two chunks ahead of the walk, as the forward stages them: a
//   lane reads four steps of each in one 16-byte shared-memory load.
// - u and w are not reduced over the lanes at every step: each lane keeps
//   its partial sums of L steps, and one reduce-scatter over the L lanes
//   leaves lane l with step l's totals, as the forward sums y. Lane l then
//   forms dx and ddt of that step and writes them over the staged x and
//   dt of the step, which no lane reads again; after the chunk they go
//   back to device memory in coalesced 128-byte rows.
// - dB_t and dC_t sum over the di channels. Each thread writes its terms
//   of the chunk's steps to shared memory; the block sums them over its 16
//   channels once a chunk (channel order), and the blocks of a thread-block
//   cluster along di (up to 8) add their sums through distributed shared
//   memory: each block owns a slice of the chunk's values, every block
//   stores its sums of that slice into the owner's shared memory (a store
//   waits for nothing), and the owner adds them in rank order into one
//   partial a cluster: a scratch (clusters, 2, B, S, N), 8.4 MB at the
//   train shape (67 MB with a partial a block). The cluster barrier is
//   split: a block arrives after its stores and waits for the others' at
//   the start of the next chunk, so the wait has that chunk's recompute
//   and walk to come in. dA and dD sum over the batch rows: each block
//   writes its (b, channel) partials to a scratch. A second launch adds
//   the partials in a fixed order.
// - What bounds it now (tools/scan_bwd_bench.py's phase clocks of one
//   block at the train shape, PERF.md): a 16-step chunk takes ~6.1k cycles
//   a block, four blocks an SM; the recompute and the walk are 38-46% of
//   them, the sums, the write-back and the block barriers (where a warp
//   waits while the SM issues the other blocks' work) the rest.
// - Channels past di (the last block) run on zeros (dt = 0 keeps h = 0),
//   so they add nothing and take part in every shuffle and barrier; steps
//   past S in the last chunk are zero-filled, so they pass dh unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatesPerLane = 2;      // P, clamped below (as the forward)
constexpr int kCh = 16;                // channels per block
constexpr int kT = 16;                 // steps per chunk: the forward's
                                       // kStateT, between its kept states
constexpr int kStages = 3;             // chunk buffers: 2 ahead, 1 walked
constexpr int kXld = kT + 4;           // row stride of a staged row of steps
constexpr int kMaxCluster = 8;         // blocks along di a cluster
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
  const float* states;                 // (B, chunks, di, N), the forward's
  float* dx;
  float* ddt;
  float* dh0;                          // written when h0 is given
  float* part_bc;                      // (clusters, 2, B, S, N)
  float* part_ad;                      // (B, di * N + di)
  int B, S, di;
};

template <int L, int P>
struct Layout {
  static constexpr int N = L * P;
  static constexpr int kThreads = kCh * L;
  static constexpr int kLs = lane_stride(P);
  static constexpr int kXBuf = kCh * kXld;      // a chunk of x, dt or gy
  static constexpr int kBBuf = L * kLs;         // a chunk of B or C
  static constexpr int kStage = 3 * kXBuf + 2 * kBBuf;
  // a channel's dB (or dC) terms of a chunk, [t][n], padded so that the
  // channels of a warp's store fall in distinct banks
  static constexpr int kRedCh = kT * N + N % 32;
  static constexpr int kRed = 2 * kCh * kRedCh; // [dB, dC][channel][t][n]
  static constexpr int kSum = 2 * kT * N;       // a chunk's [dB, dC][t][n]
  static constexpr int kFloats = kStages * kStage + kRed + 2 * kSum;
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

// The two halves of a cluster barrier: arrive releases this thread's
// writes to shared memory, wait returns once every thread of the cluster
// has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Blocks an SM: four of 128 threads (N = 16) or two of 256 (N = 32), 128
// registers a thread either way.
template <int L, int P>
__global__ void __launch_bounds__(Layout<L, P>::kThreads,
                                  Layout<L, P>::kThreads <= 128 ? 4 : 2)
    scan_bwd_kernel(const Args a) {
  using Lay = Layout<L, P>;
  constexpr int N = Lay::N, T = Lay::kThreads;
  constexpr int kRows = T / kCh;                 // x rows a pass copies
  constexpr int kXPer = kT / kRows;              // x (and dt, gy) copies
  constexpr int kBRows = T / N;                  // B rows a pass copies
  constexpr int kBPer = (kT + kBRows - 1) / kBRows;
  static_assert(T % kCh == 0 && kT % kRows == 0 && T % N == 0 &&
                    kT % L == 0 && L % 4 == 0,
                "the copy and walk loops take whole passes");
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);  // [stage] of:
  //   x, dt, gy [ch][t]; B, C [lane][j][t]
  float* const red = ring + kStages * Lay::kStage;       // [2][ch][t][n]
  // recv[c & 1][r][q]: value rank * per + q of chunk c's [dB, dC][t][n],
  // as block r of the cluster summed it; per = kSum / csize
  float* const recv = red + Lay::kRed;

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, ch = tid / L, lane = tid % L;
  const int b = blockIdx.y, d0 = blockIdx.x * kCh, d = d0 + ch;
  const bool live = d < a.di;
  const int S = a.S, di = a.di;
  const int chunks = (S + kT - 1) / kT;
  const size_t hoff = (static_cast<size_t>(b) * di + d) * N + lane * P;

  // Per-thread constants of the copies and the write-back, as the
  // forward's: thread tid moves column xcol of x/dt/gy/dx/ddt rows xrow +
  // i * kRows of each chunk, and state bn of B/C rows brow + i * kBRows.
  const int xcol = tid % kCh, xrow = tid / kCh;
  const bool xok = d0 + xcol < di;
  const size_t xoff = static_cast<size_t>(b) * S * di
                      + static_cast<size_t>(xrow) * di + d0 + xcol;
  const size_t xstep = static_cast<size_t>(kRows) * di;
  const int bn = tid % N, brow = tid / N;
  const size_t boff = (static_cast<size_t>(b) * S + brow) * N + bn;
  const int bdst = (bn / P) * Lay::kLs + (bn % P) * kXld + brow;
  const bool with_gy = a.gy != nullptr;

  auto load = [&](int c) {                       // chunk c into its buffer
    const int t0 = c * kT;
    float* st = ring + (c % kStages) * Lay::kStage;
    float* xb = st + xcol * kXld + xrow;
    const size_t at = xoff + static_cast<size_t>(t0) * di;
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const bool ok = xok && t0 + i * kRows + xrow < S;
      const size_t o = at + i * xstep;
      cp4(xb + i * kRows, a.x + o, ok);
      cp4(xb + Lay::kXBuf + i * kRows, a.dt + o, ok);
      cp4(xb + 2 * Lay::kXBuf + i * kRows, with_gy ? a.gy + o : a.x + o,
          ok && with_gy);
    }
    float* bb = st + 3 * Lay::kXBuf + bdst;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      if (brow + i * kBRows >= kT) break;
      const bool ok = t0 + i * kBRows + brow < S;
      const size_t o = boff + static_cast<size_t>(t0 + i * kBRows) * N;
      cp4(bb + i * kBRows, a.Bs + o, ok);
      cp4(bb + Lay::kBBuf + i * kBRows, a.Cs + o, ok);
    }
  };

  float Av[P], dh[P], dA[P], hnext[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    Av[j] = live ? __ldg(a.A + static_cast<size_t>(d) * N + lane * P + j)
                 : 0.f;
    dh[j] = (live && a.gh != nullptr) ? __ldg(a.gh + hoff + j) : 0.f;
    dA[j] = 0.f;
  }
  // this lane's states before chunk c, kept by the forward kernel
  auto state = [&](int c, float (&h)[P]) {
    const float* st = a.states + (static_cast<size_t>(b) * chunks + c) *
                                     di * N + static_cast<size_t>(d) * N +
                      lane * P;
#pragma unroll
    for (int j = 0; j < P; ++j) h[j] = live ? __ldg(st + j) : 0.f;
  };
  const float Dd = (live && a.D != nullptr) ? __ldg(a.D + d) : 0.f;
  float dD = 0.f;                                // this lane's steps' share

  // chunk c's slice of this block (values rank * per + q), as every block
  // of the cluster pushed its sums into recv[c & 1], added in rank order
  // into the cluster's partial
  const int per = Lay::kSum / csize;
  auto cluster_sum = [&](int c) {
    const int t0 = c * kT;
    const float* in = recv + (c & 1) * Lay::kSum;
    for (int q = tid; q < per; q += T) {
      const int e = rank * per + q;
      const int which = e / (kT * N), i = (e / N) % kT, n = e % N;
      float s = 0.f;
      for (int r = 0; r < csize; ++r) s += in[r * per + q];
      if (t0 + i < S)
        a.part_bc[(((static_cast<size_t>(blockIdx.x / csize) * 2 + which) *
                        a.B + b) * S + t0 + i) * N + n] = s;
    }
  };

  for (int i = 0; i < kStages - 1; ++i) {     // the last chunks first
    if (chunks - 1 - i >= 0) load(chunks - 1 - i);
    cp_commit();
  }
  state(chunks - 1, hnext);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kT;
    cp_wait<kStages - 2>();                      // chunk c has landed
    __syncthreads();                             // ... for every thread, and
                                                 // chunk c + 1 is written back
    if (c - (kStages - 1) >= 0) load(c - (kStages - 1));
    cp_commit();
    // the previous chunk's sums: every block of the cluster arrived with
    // them at the end of its last iteration
    if (c < chunks - 1) {
      cluster_wait();
      cluster_sum(c + 1);
    }
    float* const st = ring + (c % kStages) * Lay::kStage;
    float* const xr = st + ch * kXld;            // this channel's x, dt, gy
    float* const dr = xr + Lay::kXBuf;
    const float* const gr = xr + 2 * Lay::kXBuf;
    const float* const br = st + 3 * Lay::kXBuf + lane * Lay::kLs;
    const float* const cr = br + Lay::kBBuf;

    // the chunk's states h_{t0-1+i} and decays a_{t0+i}, from its start
    float hs[kT + 1][P], av[kT][P];
#pragma unroll
    for (int j = 0; j < P; ++j) hs[0][j] = hnext[j];
    if (c > 0) state(c - 1, hnext);              // in flight over the walk
#pragma unroll
    for (int q = 0; q < kT; q += 4) {
      float dtv[4], xv[4], bv[P][4];
      ld4(dtv, dr + q);
      ld4(xv, xr + q);
#pragma unroll
      for (int j = 0; j < P; ++j) ld4(bv[j], br + j * kXld + q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dxv = dtv[i] * xv[i];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          av[q + i][j] = expf(__fmul_rn(dtv[i], Av[j]));
          hs[q + i + 1][j] = __fadd_rn(__fmul_rn(av[q + i][j], hs[q + i][j]),
                                       __fmul_rn(dxv, bv[j][i]));
        }
      }
    }

    // the walk back, L steps a group
    float* const rb = red + ch * Lay::kRedCh + lane * P;     // dB terms
    float* const rc = rb + kCh * Lay::kRedCh;                 // dC terms
#pragma unroll
    for (int g0 = kT - L; g0 >= 0; g0 -= L) {
      float pu[L], pw[L];                        // this lane's partial u, w
#pragma unroll
      for (int q4 = L - 4; q4 >= 0; q4 -= 4) {
        const int i0 = g0 + q4;
        float gyv[4], dtv[4], xv[4], bv[P][4], cv[P][4];
        ld4(gyv, gr + i0);
        ld4(dtv, dr + i0);
        ld4(xv, xr + i0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          ld4(bv[j], br + j * kXld + i0);
          ld4(cv[j], cr + j * kXld + i0);
        }
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int i = i0 + e;
          const float dxv = dtv[e] * xv[e];
          float u = 0.f, w = 0.f, db[P], dc[P];
#pragma unroll
          for (int j = 0; j < P; ++j) {
            dh[j] = fmaf(gyv[e], cv[j][e], dh[j]);
            dc[j] = gyv[e] * hs[i + 1][j];
            db[j] = dh[j] * dxv;
            u = fmaf(dh[j], bv[j][e], u);
            const float g = dh[j] * hs[i][j] * av[i][j];
            w = fmaf(g, Av[j], w);
            dA[j] = fmaf(g, dtv[e], dA[j]);
            dh[j] *= av[i][j];
          }
          pu[q4 + e] = u;
          pw[q4 + e] = w;
          if constexpr (P == 2) {
            *reinterpret_cast<float2*>(rb + i * N) = make_float2(db[0], db[1]);
            *reinterpret_cast<float2*>(rc + i * N) = make_float2(dc[0], dc[1]);
          } else {
#pragma unroll
            for (int j = 0; j < P; ++j) {
              rb[i * N + j] = db[j];
              rc[i * N + j] = dc[j];
            }
          }
        }
      }
      // reduce-scatter over the L lanes (as the forward's y): lane l ends
      // with the sums over the channel's states of step g0 + l
#pragma unroll
      for (int m = L / 2; m >= 1; m >>= 1) {
        const bool up = lane & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float su = up ? pu[i] : pu[i + m];
          const float sw = up ? pw[i] : pw[i + m];
          const float ku = up ? pu[i + m] : pu[i];
          const float kw = up ? pw[i + m] : pw[i];
          pu[i] = ku + __shfl_xor_sync(kFull, su, m);
          pw[i] = kw + __shfl_xor_sync(kFull, sw, m);
        }
      }
      // dx and ddt of step g0 + lane over its staged x and dt: every lane
      // of the channel is past its reads of the group's steps
      const int i = g0 + lane;
      const float gv = gr[i], dtv = dr[i], xv = xr[i];
      xr[i] = fmaf(gv, Dd, pu[0] * dtv);
      dr[i] = fmaf(pu[0], xv, pw[0]);
      dD = fmaf(gv, xv, dD);
    }
    __syncthreads();                             // the chunk's dx, ddt, terms

    // dx and ddt back to device memory, coalesced
    if (xok) {
      const float* xb = st + xcol * kXld + xrow;
      const size_t at = xoff + static_cast<size_t>(t0) * di;
#pragma unroll
      for (int i = 0; i < kXPer; ++i)
        if (t0 + i * kRows + xrow < S) {
          a.dx[at + i * xstep] = xb[i * kRows];
          a.ddt[at + i * xstep] = xb[Lay::kXBuf + i * kRows];
        }
    }
    // the block's dB and dC terms summed over its channels, in order
    // (every load issued before the adds, so that their latencies
    // overlap), each pushed to the block of the cluster that adds its
    // slice: a store to distributed shared memory, which waits for nothing
    float* const out = recv + (c & 1) * Lay::kSum + rank * per;
    static_assert(Lay::kSum % T == 0, "whole passes");
#pragma unroll
    for (int e = tid; e < Lay::kSum; e += T) {
      const float* src = red + (e / (kT * N)) * kCh * Lay::kRedCh +
                         e % (kT * N);
      float v[kCh];
#pragma unroll
      for (int ch2 = 0; ch2 < kCh; ++ch2) v[ch2] = src[ch2 * Lay::kRedCh];
      float s = 0.f;
#pragma unroll
      for (int ch2 = 0; ch2 < kCh; ++ch2) s += v[ch2];
      cluster.map_shared_rank(out, e / per)[e % per] = s;
    }
    // this block's sums are out: each block adds its slice at the start of
    // the next chunk. Buffer c & 1 was last read for chunk c + 2, by every
    // block before its arrival for chunk c + 1, which this block's wait
    // above has seen.
    cluster_arrive();
  }
  cluster_wait();
  cluster_sum(0);
  cluster_arrive();                              // every block is past its
  cluster_wait();                                // last sums before any leaves
#pragma unroll
  for (int m = 1; m < L; m <<= 1) dD += __shfl_xor_sync(kFull, dD, m);
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

// dB and dC: the clusters' partials added in cluster order; dA and dD: the
// batch rows' partials added in row order.
__global__ void scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                    const float* __restrict__ part_ad,
                                    float* __restrict__ dB,
                                    float* __restrict__ dC,
                                    float* __restrict__ dA,
                                    float* __restrict__ dD, int parts, int B,
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
      for (int k = 0; k < parts; ++k)
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

// Blocks along di a cluster: the largest of 8, 4, 2, 1 that divides them.
int cluster_size(int blocks) {
  int c = kMaxCluster;
  while (blocks % c) c /= 2;
  return c;
}

template <int L, int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Lay = Layout<L, P>;
  constexpr size_t smem = sizeof(float) * Lay::kFloats;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const int blocks = (a.di + kCh - 1) / kCh;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks, a.B);
  cfg.blockDim = dim3(Lay::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, scan_bwd_kernel<L, P>, a);
}

template <int N>
cudaError_t launch_n(const Args& a, cudaStream_t stream) {
  constexpr int L = lanes_for(N);
  return launch<L, N / L>(a, stream);
}

}  // namespace

// C entry point (loaded with ctypes). All pointers are device pointers of
// contiguous float32 tensors: the forward's inputs x, dt, A, Bs, Cs, D
// (may be null: no skip term) and h0 (may be null: zeros); `states`
// (B, ceil(S / 16), di, N), the states mamba_scan_forward kept; the
// cotangents gy (B, S, di) and gh (B, di, N), each may be null (zero); the
// gradients dx, ddt, dA, dB, dC, dD (null when D is) and dh0 (null when h0
// is); scratch: part_bc (clusters, 2, B, S, N), clusters =
// mamba_scan_bwd_parts(di), and part_ad (B, di * N + di). N must be 4, 8,
// 16 or 32, S at least 1; `stream` is a cudaStream_t. Launches the reverse
// scan, then the kernel that adds the partial sums. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int mamba_scan_backward(
    const float* x, const float* dt, const float* A, const float* Bs,
    const float* Cs, const float* D, const float* h0, const float* gy,
    const float* gh, const float* states, float* dx, float* ddt, float* dA,
    float* dB, float* dC, float* dD, float* dh0, float* part_bc,
    float* part_ad, int B, int S, int di, int N, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || di < 0 ||
      (h0 != nullptr && dh0 == nullptr) || (D != nullptr && dD == nullptr) ||
      (B > 0 && di > 0 && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,  dt,  A,   Bs,      Cs,      D, h0, gy, gh, states,
               dx, ddt, dh0, part_bc, part_ad, B, S,  di};
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
  const int chans = (di + kCh - 1) / kCh;
  scan_bwd_sum_kernel<<<blocks, threads, 0, s>>>(
      part_bc, part_ad, dB, dC, dA, D != nullptr ? dD : nullptr,
      chans > 0 ? chans / cluster_size(chans) : 0, B, S, di, N);
  return static_cast<int>(cudaGetLastError());
}

// The clusters, and so the dB/dC partials, of a backward at this di.
extern "C" int mamba_scan_bwd_parts(int di) {
  const int chans = (di + kCh - 1) / kCh;
  return chans > 0 ? chans / cluster_size(chans) : 0;
}
