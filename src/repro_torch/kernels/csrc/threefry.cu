// jax.random's Threefry-2x32 draws for Hopper (sm_90a): normal weights and
// Gumbel noise, bit for bit the reference's.
//
// Not a TPU kernel: the reference draws its LM weights and its sampled
// tokens with jax.random (repro/models/common.py::normal_init,
// repro/launch/serve.py), which XLA lowers on its own. This kernel makes
// the same numbers on the card, so that a seed gives the port the
// reference's model. Its plain version is kernels/ref.py's
// random_normal_ref and random_gumbel_ref.
//
// What it computes, for each key k of a stack (blockIdx.y) and each
// element i in [offset, offset + n) of that key's flat draw (jax 0.9.0,
// jax_threefry_partitionable on, the default):
//   bits(i) = x0 ^ x1 of threefry2x32(k, (i >> 32, i & 0xffffffff))
//   f       = bits(i) >> 9 as the mantissa of a float in [1, 2), minus 1
//   u       = max(lo, fma(f, hi - lo, lo))              (jax.random.uniform)
//   normal: out = stddev * (sqrt2 * erf_inv(u)), lo = nextafter(-1, 0),
//           hi = 1, written as fp32 or rounded to bf16 (normal_init's cast)
//   gumbel: out = -log(-log(u)), lo = tiny, hi = 1      (jax.random.gumbel)
// with XLA's CPU lowerings of erf_inv (Giles' single-precision
// polynomials), log1p (Cephes) and log (Cephes logf), FMAs exactly where
// XLA fuses them.
//
// Bit-equality: nvcc contracts a * b + c into an FMA by default, and
// these flags do not say otherwise. So every fp32 operation is an
// intrinsic with its rounding written out: __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and __fsqrt_rn (IEEE, never contracted), and
// __fmaf_rn exactly where XLA's lowering has an FMA. Constants are hex
// literals of the fp32 values the plain version (kernels/ref.py) holds.
//
// Bound on an H100: at qwen3-8b's 8.19 B parameters a full draw writes
// 32.8 GB of fp32, 9.8 ms at 3.35 TB/s; but each draw issues a few hundred
// instructions (20 Threefry rounds of add, funnel shift and xor; then the
// uniform, log1p, erf_inv's polynomial), so the SMs' instruction issue
// bounds it: chip_smoke.py counts the kernel's instructions a draw from
// `cuobjdump -sass` and holds the time to them. The design is the simplest
// that is right: one thread an element, straight-line code (both erf_inv
// branches and both log1p paths are computed and selected, as XLA's
// lowering does), one coalesced store a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 32 random bits of counter i under key (k0, k1): Threefry-2x32, 20
// rounds, the two output words xored.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g % 2][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return x0 ^ x1;
}

// jax.random.uniform's float: one FMA scales and shifts [0, 1) to
// [lo, lo + scale), then max(lo, .).
__device__ __forceinline__ float uniform(uint32_t bits, float lo,
                                         float scale) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, scale, lo));
}

// XLA's CPU fp32 log (Cephes logf): y = 2^e m, m in [sqrt(1/2), sqrt(2)).
__device__ __forceinline__ float logf_xla(float y) {
  const uint32_t b = __float_as_uint(fmaxf(y, 0x1p-126f));
  float e = __fadd_rn(__int2float_rn(static_cast<int>(b >> 23) - 127), 1.0f);
  const float m = __uint_as_float((b & 0x7FFFFFu) | 0x3F000000u);
  const bool low = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float a = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a370p-4f), x,
                      0x1.de4a34p-4f);
  const float b2 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x,
                             -0x1.555ca0p-3f);
  const float c = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x,
                            0x1.555554p-2f);
  a = __fmaf_rn(__fmaf_rn(__fmaf_rn(a, x3, b2), x3, c), x3,
                __fmul_rn(e, -0x1.bd0106p-13f));
  float out = __fmaf_rn(e, 0x1.63p-1f,
                        __fadd_rn(__fmaf_rn(x2, -0.5f, x), a));
  if (y < 0.0f) out = __int_as_float(0x7FC00000);        // nan
  if (y == 0.0f) out = -__int_as_float(0x7F800000);      // -inf
  if (y == __int_as_float(0x7F800000)) out = y;          // inf
  return out;
}

// XLA's CPU fp32 log1p: Cephes' rational x - x^2/2 + x^3 P(x)/Q(x) for
// |x| < sqrt(2) - 1, else log(1 + x).
__device__ __forceinline__ float log1p_xla(float x) {
  const float x2 = __fmul_rn(x, x);
  float num = 0x1.7bc096p-15f;
  num = __fmaf_rn(num, x, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, x, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, x, 0x1.de9738p+4f);
  num = __fmaf_rn(num, x, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, x, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, x, 0x1.40a202p+4f);
  float den = 1.0f;
  den = __fmaf_rn(den, x, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, x, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, x, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, x, 0x1.351946p+8f);
  den = __fmaf_rn(den, x, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, x, 0x1.e0f304p+5f);
  const float small = __fadd_rn(
      x, __fmaf_rn(x2, -0.5f,
                   __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
  const float big = logf_xla(__fadd_rn(x, 1.0f));
  return fabsf(x) < 0x1.a8279ap-2f ? small : big;
}

// XLA's CPU erf_inv of fp32 x in [-1, 1]: Giles' polynomial in
// w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2).
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w = -log1p_xla(-__fmul_rn(x, x));
  const bool lo = w < 5.0f;
  const float t = lo ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lo ? 0x1.e2cb10p-26f : -0x1.a3e136p-13f;
  p = __fmaf_rn(p, t, lo ? 0x1.70966cp-22f : 0x1.a76ad6p-14f);
  p = __fmaf_rn(p, t, lo ? -0x1.d8e6aep-19f : 0x1.61b8e4p-10f);
  p = __fmaf_rn(p, t, lo ? -0x1.26b582p-18f : -0x1.e17bcep-9f);
  p = __fmaf_rn(p, t, lo ? 0x1.ca65b6p-13f : 0x1.7824f6p-8f);
  p = __fmaf_rn(p, t, lo ? -0x1.48a810p-10f : -0x1.f38baep-8f);
  p = __fmaf_rn(p, t, lo ? -0x1.11c9dep-8f : 0x1.354afcp-7f);
  p = __fmaf_rn(p, t, lo ? 0x1.f91ec6p-3f : 0x1.006db6p+0f);
  p = __fmaf_rn(p, t, lo ? 0x1.805c5ep+0f : 0x1.6a9efcp+1f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000))
                          : __fmul_rn(p, x);
}

__device__ __forceinline__ void store(float* out, size_t at, float v) {
  out[at] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, size_t at,
                                      float v) {
  out[at] = __float2bfloat16_rn(v);
}

// out[k, j] = stddev * normal(key k)[offset + j], j < n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normal_kernel(const uint32_t* __restrict__ keys, long long n,
                  long long offset, float stddev, T* __restrict__ out) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t k0 = keys[2 * blockIdx.y], k1 = keys[2 * blockIdx.y + 1];
  const uint32_t bits =
      threefry_bits(k0, k1, static_cast<uint64_t>(offset + j));
  // uniform(nextafter(-1, 0), 1): lo = -0x1.fffffep-1, hi - lo = 2 in fp32
  const float u = uniform(bits, -0x1.fffffep-1f, 2.0f);
  const float z = __fmul_rn(0x1.6a09e6p+0f, erfinv_xla(u));   // sqrt(2)
  store(out, static_cast<size_t>(blockIdx.y) * n + j, __fmul_rn(stddev, z));
}

// out[k, j] = gumbel(key k)[offset + j], j < n.
__global__ void __launch_bounds__(kThreads)
    gumbel_kernel(const uint32_t* __restrict__ keys, long long n,
                  long long offset, float* __restrict__ out) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t k0 = keys[2 * blockIdx.y], k1 = keys[2 * blockIdx.y + 1];
  const uint32_t bits =
      threefry_bits(k0, k1, static_cast<uint64_t>(offset + j));
  // uniform(tiny, 1): hi - lo = 1 in fp32
  const float u = uniform(bits, 0x1p-126f, 1.0f);
  out[static_cast<size_t>(blockIdx.y) * n + j] = -logf_xla(-logf_xla(u));
}

bool bad_shape(int n_keys, long long n, long long offset) {
  return n_keys < 1 || n_keys > 65535 || n < 0 || offset < 0 ||
         (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL;
}

}  // namespace

// keys: n_keys uint32[2] keys on the device; out: (n_keys, n) fp32, or
// bf16 if out_bf16. Returns the CUDA error of the launch (0: launched).
extern "C" int threefry_normal(const uint32_t* keys, int n_keys, long long n,
                               long long offset, float stddev, void* out,
                               int out_bf16, void* stream) {
  if (bad_shape(n_keys, n, offset))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_keys));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    normal_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        keys, n, offset, stddev, static_cast<__nv_bfloat16*>(out));
  else
    normal_kernel<float><<<grid, kThreads, 0, s>>>(
        keys, n, offset, stddev, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_gumbel(const uint32_t* keys, int n_keys, long long n,
                               long long offset, float* out, void* stream) {
  if (bad_shape(n_keys, n, offset))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_keys));
  gumbel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, n, offset, out);
  return static_cast<int>(cudaGetLastError());
}
