// Per-lane random draws for Hopper (sm_90a): threefry2x32-20 of every
// lane's key at n counters, written as keys, bits, uniform floats,
// integers or normals.
//
// The port's counterpart of XLA's threefry (the `jax.random` functions the
// JAX package calls: split, fold_in, bits, uniform), not of a Pallas
// kernel. With jax_threefry_partitionable, JAX's default, every one of
// them is the block T(key, j) = threefry2x32-20(key, (0, j)) of a counter
// j: split(key, n)[j] = T(key, j), fold_in(key, d) = T(key, d), bits[j] =
// T[0] ^ T[1], and uniform builds a float32 in [1, 2) from the top 23 bits
// (bits >> 9 | 0x3F800000), subtracts 1 and scales. The plain twin is
// `threefry_plain` in spriteworld_torch/ops/lane_random.py; the two agree
// bit for bit (integer arithmetic, and the float scale one fused
// multiply-add, rounded once, as XLA contracts JAX's `floats * (hi - lo) +
// lo`; the twin rounds once too). A normal is JAX's construction,
// sqrt(2) erfinv(u) of that uniform on [nextafter(-1, 0), 1), taken in
// float64 (CUDA's erfinv, which torch's CUDA erfinv calls too) and rounded
// once to float32: one launch where the twin takes five.
//
// What bounds it. A lane reads its 8-byte key and writes 4n bytes (8n for
// keys): at 2048 lanes and n = 64, 0.5 MB, 0.16 us at 3.35 TB/s. Its
// operations are 20 rounds of add, rotate and xor and 6 key injections a
// block, ~100 32-bit integer operations: 13 M operations at that size, a
// few microseconds of the card's integer rate at the very most. At the
// sizes a step draws (a few thousand blocks) the launch itself dominates.
//
// Design. One thread a (lane, counter) block, 256 threads a block, no
// shared memory. The output index is the thread's index in either layout:
// lanes first ([L][n]) or counters first ([n][L], which the rejection
// rounds take). Keys are read through a lane stride, so a key that is a
// slice of a split (a view with stride 2n) is read in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 0, kBits = 1, kUniform = 2, kRandint = 3, kNormal = 4;

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

__global__ void __launch_bounds__(kThreads)
lane_random_kernel(const uint32_t* __restrict__ keys, long long lanes,
                   long long key_stride, int n, uint32_t start, int mode,
                   int counters_first, float lo, float span, int lo_i,
                   uint32_t span_u, void* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
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
  uint32_t x0 = 0u, x1 = start + static_cast<uint32_t>(j);
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
        mode == kUniform
            ? u
            : __double2float_rn(
                  __dmul_rn(erfinv(static_cast<double>(u)),
                            1.4142135623730951));
  } else {
    static_cast<int*>(out)[t] = lo_i + static_cast<int>(b % span_u);
  }
}

}  // namespace

// Blocks T(key, start + j), j < n, of `lanes` keys (two words each, lane
// l's at keys + l * key_stride), written in `mode` to `out`: lanes first,
// or counters first. Launches on `stream`; returns the CUDA error code (0
// on success).
extern "C" int lane_random_launch(const uint32_t* keys, long long lanes,
                                  long long key_stride, int n,
                                  uint32_t start, int mode,
                                  int counters_first, float lo, float span,
                                  int lo_i, uint32_t span_u, void* out,
                                  void* stream) {
  if (lanes <= 0 || n <= 0) return 0;
  if (mode < kKeys || mode > kNormal || (mode == kRandint && span_u == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = lanes * n;
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
