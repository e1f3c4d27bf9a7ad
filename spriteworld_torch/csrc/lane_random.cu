// Per-lane random draws for Hopper (sm_90a): threefry2x32-20 of every
// lane's key at n counters, written as keys, bits, uniform floats,
// integers or normals; or the split chain of every lane's key.
//
// The port's counterpart of XLA's threefry and of the `jax.random` draws
// the JAX package calls (split, fold_in, bits, uniform, randint, normal,
// choice's uniform and its rejection loop's key chain), not of a Pallas
// kernel. With jax_threefry_partitionable, JAX's default, every one of
// them is built on the block T(key, j) = threefry2x32-20(key, (0, j)) of a
// counter j: split(key, n)[j] = T(key, j), fold_in(key, d) = T(key, d),
// bits[j] = T[0] ^ T[1], and uniform builds a float32 in [1, 2) from the
// top 23 bits (bits >> 9 | 0x3F800000), subtracts 1 and scales.
//   randint: the key's halves k1 = T(key, 0), k2 = T(key, 1); a = bits of
//     k1 and b = bits of k2 at the counter; lo + ((a % span) * m + b %
//     span) % span in uint32, m = (2^16 % span)^2 % span, the square
//     wrapped in uint32 (span is 1 where hi <= lo).
//   normal: float32(sqrt 2) * ErfInv32(u) of the uniform u on
//     [nextafter(-1, 0), 1), XLA's float32 ErfInv32: w = -log1p(-u*u)
//     (log1p in float64, rounded once), its w < 5 or w >= 5 polynomial in
//     w - 2.5 or sqrt(w) - 3 by fused multiply-adds, times u.
//   chain: per lane, n rounds of JAX's rejection loop `k, sub = split(k)`:
//     sub_r = T(s_r, 1), s_{r+1} = T(s_r, 0), s_0 = the key; the n subkeys
//     and s_n are written.
// The plain twin is `threefry_plain` in spriteworld_torch/ops/lane_random.py;
// the two agree bit for bit (integer arithmetic; every float operation
// here is one IEEE operation with an explicit rounding, __f*_rn and
// __fmaf_rn, which the twin rounds the same way; log1p is the float64
// one rounded once, so the twin on the card equals the kernel, and on the
// CPU, whose float64 log1p is its own, can differ only where the two round
// across a float32 boundary: chip_smoke.py's phase 12 counts those).
//
// What bounds it. A lane reads its 8-byte key and writes 4n bytes (8n for
// keys): at 2048 lanes and n = 64, 0.5 MB, 0.16 us at 3.35 TB/s. Its
// operations are 20 rounds of add, rotate and xor and 6 key injections a
// block, ~100 32-bit integer operations (four blocks an output of randint,
// two a round of the chain): 13 M operations at that size, a few
// microseconds of the card's integer rate at the very most. At the sizes a
// step draws (a few thousand blocks) the launch itself dominates.
//
// Design. One thread a (lane, counter) output, 256 threads a block, no
// shared memory. The output index is the thread's index in either layout:
// lanes first ([L][n]) or counters first ([n][L], which the rejection
// rounds take). The chain is serial within a lane: one thread a lane walks
// its n rounds and writes [n + 1] keys in the same layouts. Keys are read
// through a lane stride, so a key that is a slice of a split (a view with
// stride 2n) is read in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 0, kBits = 1, kUniform = 2, kRandint = 3, kNormal = 4,
              kChain = 5;

// XLA's ErfInv32 coefficients, highest degree first, for w < 5 and w >= 5
// (the twin's _ERFINV_LT5 and _ERFINV_GE5).
__constant__ float kErfInvLt5[9] = {
    2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
    -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
    -0.00417768164f,  0.246640727f,    1.50140941f};
__constant__ float kErfInvGe5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f,
    -0.00367342844f,  0.00573950773f,  -0.0076224613f,
    0.00943887047f,   1.00167406f,     2.83297682f};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 with 20 rounds of key (k0, k1) on the block (x0, x1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ uint32_t block_bits(uint32_t k0, uint32_t k1,
                                               uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// XLA's float32 ErfInv32 (see the header).
__device__ __forceinline__ float erfinv32(float x) {
  float w = -__double2float_rn(log1p(static_cast<double>(__fmul_rn(x, -x))));
  const bool lt = w < 5.0f;
  const float* c = lt ? kErfInvLt5 : kErfInvGe5;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, c[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000))
                          : __fmul_rn(p, x);
}

// The split chain of one lane's key: n subkeys and the state after them,
// at out[r] (r <= n), `stride` keys apart.
__device__ __forceinline__ void chain(uint32_t s0, uint32_t s1, int n,
                                      uint2* out, long long stride) {
  for (int r = 0; r < n; ++r) {
    uint32_t a0 = 0u, a1 = 1u, b0 = 0u, b1 = 0u;
    threefry(s0, s1, a0, a1);
    threefry(s0, s1, b0, b1);
    out[r * stride] = make_uint2(a0, a1);
    s0 = b0;
    s1 = b1;
  }
  out[n * stride] = make_uint2(s0, s1);
}

__global__ void __launch_bounds__(kThreads)
lane_random_kernel(const uint32_t* __restrict__ keys, long long lanes,
                   long long key_stride, int n, uint32_t start, int mode,
                   int counters_first, float lo, float span, int lo_i,
                   uint32_t span_u, void* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (mode == kChain) {
    if (t >= lanes) return;
    uint2* o = reinterpret_cast<uint2*>(out);
    chain(__ldg(keys + t * key_stride), __ldg(keys + t * key_stride + 1), n,
          counters_first ? o + t : o + t * (n + 1),
          counters_first ? lanes : 1);
    return;
  }
  if (t >= lanes * n) return;
  long long lane;
  int j;
  if (counters_first) {
    j = static_cast<int>(t / lanes);
    lane = t - static_cast<long long>(j) * lanes;
  } else {
    lane = t / n;
    j = static_cast<int>(t - lane * n);
  }
  const uint32_t k0 = __ldg(keys + lane * key_stride);
  const uint32_t k1 = __ldg(keys + lane * key_stride + 1);
  const uint32_t counter = start + static_cast<uint32_t>(j);
  if (mode == kRandint) {
    uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
    threefry(k0, k1, h0, h1);
    threefry(k0, k1, l0, l1);
    const uint32_t a = block_bits(h0, h1, counter);
    const uint32_t b = block_bits(l0, l1, counter);
    uint32_t m = 65536u % span_u;
    m = m * m % span_u;  // the square wraps in uint32, as JAX's does
    const uint32_t offset = (a % span_u * m + b % span_u) % span_u;
    static_cast<uint32_t*>(out)[t] = static_cast<uint32_t>(lo_i) + offset;
    return;
  }
  uint32_t x0 = 0u, x1 = counter;
  threefry(k0, k1, x0, x1);
  if (mode == kKeys) {
    reinterpret_cast<uint2*>(out)[t] = make_uint2(x0, x1);
    return;
  }
  const uint32_t b = x0 ^ x1;
  if (mode == kBits) {
    static_cast<uint32_t*>(out)[t] = b;
  } else if (mode == kUniform || mode == kNormal) {
    const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(lo, __fmaf_rn(f, span, lo));
    static_cast<float*>(out)[t] =
        mode == kUniform ? u : __fmul_rn(erfinv32(u), 1.41421356f);
  }
}

}  // namespace

// Blocks T(key, start + j), j < n, of `lanes` keys (two words each, lane
// l's at keys + l * key_stride), written in `mode` to `out`: lanes first,
// or counters first (the chain: n + 1 keys a lane, from one thread a
// lane). Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int lane_random_launch(const uint32_t* keys, long long lanes,
                                  long long key_stride, int n,
                                  uint32_t start, int mode,
                                  int counters_first, float lo, float span,
                                  int lo_i, uint32_t span_u, void* out,
                                  void* stream) {
  if (lanes <= 0 || n <= 0) return 0;
  if (mode < kKeys || mode > kChain || (mode == kRandint && span_u == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = mode == kChain ? lanes : lanes * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  lane_random_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      keys, lanes, key_stride, n, start, mode, counters_first, lo, span,
      lo_i, span_u, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
