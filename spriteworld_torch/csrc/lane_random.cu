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
//   scene (a second kernel, lane_random_scene_kernel): a whole
//     `GenerateSprites` scene whose factor distribution is a tree of
//     `Product`s over `Continuous` and `Discrete` leaves, as the generator's
//     plain body draws it: k = split(key, 2); the count is a constant or
//     randint(k[0], 1, lo, hi); slot s draws from T(k[1], s), each Product
//     level from T(its key, i) of its i-th component; a Continuous leaf is
//     the uniform above cast through its dtype, a Discrete one a candidate
//     picked by randint(0, n) or by JAX's choice (the first index whose
//     float32 cumulative sum reaches (1 - u) * cum[-1]). A dead slot (slot
//     >= count) keeps the default row.
//   tree (a third kernel, lane_random_tree_kernel): the whole scene of a
//     generator tree of Shuffle, SampleGenerator and ChainGenerators nodes
//     over such GenerateSprites leaves, as the composites' plain bodies draw
//     it, keys split as theirs split, each lane drawing only the branch its
//     SampleGenerators chose (the others' draws are what their selection
//     throws away).
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
//
// The scene mode replaces the ~45 small PyTorch kernels of a generator's
// plain body (splits, one draw a leaf, status, gathers, column writes,
// masks) by one launch over the generator's descriptor table (built once
// on the host, `lane_random.scene_table`; its layout below). One thread a
// (lane, slot, leaf) derives its leaf's key down the leaf's path of
// Product components, draws, and writes its column (the default in a dead
// slot); the leaf-0 thread of a slot writes the columns no leaf writes,
// and the count and status once a lane. Each thread recomputes the lane's
// count and the keys above its leaf: at a few thousand lanes the card has
// threads to spare, and a thread's serial chain is what bounds the launch
// (a block's 20 rounds are ~70 dependent integer operations), so a chain
// of 3-7 blocks a thread beats one of 20-30 a (lane, slot).
//
// The tree mode replaces the ~240 kernels of a composite tree's plain bodies
// (a scene launch a leaf of every branch, the chains' stable sorts and
// gathers, the selection's wheres, the shuffle's sort) by one launch, one
// warp a lane (lane_random_tree_kernel): the scene has at most 32 slots, so
// the threads hold its positions and a chain's partition, a selection and a
// shuffle's stable ranks are warp shuffles; the threads then share the
// draws of the live slots, a (slot, leaf record) each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 0, kBits = 1, kUniform = 2, kRandint = 3, kNormal = 4,
              kChain = 5;

// A scene's descriptor table (int32 words; `lane_random.scene_table` writes
// it): a header of kSceneHeader words, [leaves, count lo, count span (0:
// the count is lo), the mask of the columns no leaf writes, the width w of
// a row of factors], the default factor row as float bits x w, then a
// record of kSceneRecord words a leaf, then a pool of float words
// (candidates, cumulative sums; their offsets count from the table's
// start).
// A record is [op, column, depth d, a, b, c, 0, 0, path x kSceneMaxDepth]:
// the leaf's key is T(...T(T(slot's key, path[0]), path[1])..., path[d -
// 1]), path[i] being the component's index in its Product; it writes its
// column: kSceneUniform with a = lo, b = span (float bits), c = the cast;
// kSceneRandint and kSceneChoice with a = n candidates, b = their word in
// the pool, and c = the word of the cumulative sums (choice).
constexpr int kSceneMaxDepth = 8;
constexpr int kSceneHeader = 5, kSceneRecord = 8 + kSceneMaxDepth;
constexpr int kSceneUniform = 0, kSceneRandint = 1, kSceneChoice = 2;
// A generator tree's table (int32 words; `lane_random.tree_table` writes
// it): a header of kTreeHeader words, [nodes, the root's slots kmax (at most
// 32, a warp's threads), the width w of a row, the most records of a leaf's
// scene table], the default factor row as float bits x w, then a record of
// kTreeRecord words a node in preorder (the root first), then a pool of the
// children's node indices, the SampleGenerators' cumulative sums (float
// bits) and the leaves' scene tables (kSceneHeader's layout), each found by
// its word from the table's start.
// A record is [kind, children n, the word of its children's indices (a
// leaf: the word of its scene table), a SampleGenerator's word of its
// cumulative sums (-1: its choice is randint(0, n))]. Composite nodes nest
// at most kTreeMaxDepth deep.
constexpr int kTreeHeader = 4, kTreeRecord = 4, kTreeMaxDepth = 8;
constexpr int kTreeLeaf = 0, kTreeChain = 1, kTreeSample = 2,
              kTreeShuffle = 3;
constexpr int kTreeThreads = 128;  // four lanes a block, a warp each
constexpr unsigned kWarp = 0xFFFFFFFFu;
// The dtypes a uniform is cast through (torch's conversions on the card:
// float to int truncates; float to uint8 goes through int64).
constexpr int kCastNone = 0, kCastInt32 = 1, kCastInt64 = 2, kCastUint8 = 3;

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

// The key T(key, j).
__device__ __forceinline__ uint2 block_key(uint2 k, uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry(k.x, k.y, x0, x1);
  return make_uint2(x0, x1);
}

// JAX's randint offset in [0, span_u) at `counter` (see the header).
__device__ __forceinline__ uint32_t randint_offset(uint32_t k0, uint32_t k1,
                                                   uint32_t counter,
                                                   uint32_t span_u) {
  uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
  threefry(k0, k1, h0, h1);
  threefry(k0, k1, l0, l1);
  const uint32_t a = block_bits(h0, h1, counter);
  const uint32_t b = block_bits(l0, l1, counter);
  uint32_t m = 65536u % span_u;
  m = m * m % span_u;  // the square wraps in uint32, as JAX's does
  return (a % span_u * m + b % span_u) % span_u;
}

// JAX's uniform float32 on [lo, lo + span) of the bits b.
__device__ __forceinline__ float uniform_of(uint32_t b, float lo,
                                            float span) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, span, lo));
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
    static_cast<uint32_t*>(out)[t] = static_cast<uint32_t>(lo_i) +
                                     randint_offset(k0, k1, counter, span_u);
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
    const float u = uniform_of(b, lo, span);
    static_cast<float*>(out)[t] =
        mode == kUniform ? u : __fmul_rn(erfinv32(u), 1.41421356f);
  }
}

// A uniform cast through a leaf's dtype and back to float32, as torch's
// `.to(dtype).to(torch.float32)` converts on the card.
__device__ __forceinline__ float cast_through(float u, int cast) {
  switch (cast) {
    case kCastInt32:
      return __int2float_rn(__float2int_rz(u));
    case kCastInt64:
      return __ll2float_rn(__float2ll_rz(u));
    case kCastUint8:
      return static_cast<float>(static_cast<unsigned char>(__float2ll_rz(u)));
    case kCastNone:
    default:
      return u;
  }
}

// JAX's choice of an index in [0, n) from the key k: the first index whose
// float32 cumulative sum cum reaches (1 - u) * cum[n - 1] of the uniform u
// of its bits (searchsorted, left).
__device__ __forceinline__ int choice_of(uint2 k, const int* cum, int n) {
  const float u = uniform_of(block_bits(k.x, k.y, 0u), 0.0f, 1.0f);
  const float target =
      __fmul_rn(__fsub_rn(1.0f, u), __int_as_float(__ldg(cum + n - 1)));
  int i = 0;
  while (i < n - 1 && __int_as_float(__ldg(cum + i)) < target) ++i;
  return i;
}

// The value that the leaf record `rec` of the scene table `table` draws in
// a slot whose key is `k`: the leaf's key down its path of Product
// components, then its draw (see kSceneHeader).
__device__ __forceinline__ float draw_record(const int* table, const int* rec,
                                             uint2 k) {
  const int op = __ldg(rec), depth = __ldg(rec + 2);
  for (int d = 0; d < depth; ++d) {
    k = block_key(k, static_cast<uint32_t>(__ldg(rec + 8 + d)));
  }
  if (op == kSceneUniform) {
    return cast_through(uniform_of(block_bits(k.x, k.y, 0u),
                                   __int_as_float(__ldg(rec + 3)),
                                   __int_as_float(__ldg(rec + 4))),
                        __ldg(rec + 5));
  }
  const int n = __ldg(rec + 3);
  const int i = op == kSceneRandint
                    ? static_cast<int>(randint_offset(
                          k.x, k.y, 0u, static_cast<uint32_t>(n)))
                    : choice_of(k, table + __ldg(rec + 5), n);
  return __int_as_float(__ldg(table + __ldg(rec + 4) + i));
}

// One thread a (lane, slot, leaf) of a `GenerateSprites` scene from the
// descriptor table (see kSceneHeader): the leaf's column of the slot's
// row, drawn in a dead slot too (its default is written); the leaf-0
// thread also writes the columns no leaf writes and, in slot 0, the lane's
// count and its status (true: a leaf tree rejects nothing). A tree without
// leaves has one thread a slot.
__global__ void __launch_bounds__(kThreads)
lane_random_scene_kernel(const uint32_t* __restrict__ keys, long long lanes,
                         long long key_stride, int kmax, int leaves,
                         const int* __restrict__ table,
                         float* __restrict__ factors, int* __restrict__ num,
                         bool* __restrict__ ok) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int per_slot = leaves > 0 ? leaves : 1;
  if (t >= lanes * kmax * per_slot) return;
  const long long cell = t / per_slot;  // lane * kmax + slot
  const int leaf = static_cast<int>(t - cell * per_slot);
  const long long lane = cell / kmax;
  const int slot = static_cast<int>(cell - lane * kmax);
  const uint2 key = make_uint2(__ldg(keys + lane * key_stride),
                               __ldg(keys + lane * key_stride + 1));
  int count = __ldg(table + 1);
  const uint32_t count_span = static_cast<uint32_t>(__ldg(table + 2));
  if (count_span != 0u) {
    const uint2 k = block_key(key, 0u);
    count = static_cast<int>(static_cast<uint32_t>(count) +
                             randint_offset(k.x, k.y, 0u, count_span));
  }
  const bool live = slot < count;
  const int width = __ldg(table + 4);
  const int* row_default = table + kSceneHeader;
  float* row = factors + cell * width;
  if (leaf == 0) {
    for (int m = __ldg(table + 3); m != 0; m &= m - 1) {
      const int c = __ffs(m) - 1;
      row[c] = __int_as_float(__ldg(row_default + c));
    }
    if (slot == 0) {
      num[lane] = count;
      ok[lane] = true;
    }
  }
  if (leaf >= leaves) return;
  const int* rec = table + kSceneHeader + width + leaf * kSceneRecord;
  const int column = __ldg(rec + 1);
  const float v = draw_record(
      table, rec, block_key(block_key(key, 1u), static_cast<uint32_t>(slot)));
  row[column] = live ? v : __int_as_float(__ldg(row_default + column));
}

// T(k, j), computed by the warp's thread 0 and read by all its threads.
__device__ __forceinline__ uint2 warp_block_key(uint2 k, uint32_t j, int t) {
  uint2 out = make_uint2(0u, 0u);
  if (t == 0) out = block_key(k, j);
  return make_uint2(__shfl_sync(kWarp, out.x, 0),
                    __shfl_sync(kWarp, out.y, 0));
}

// A Shuffle over the rows at positions [start, end) of the scene, each
// thread holding the row of its own position in `row`: the order key is
// T(key, 1); position start + j draws the uniform of T(order, j), and its
// row moves to start + its stable rank (the rows whose uniform is smaller,
// or equal at a lower position), which is where a stable sort of the
// uniforms, +inf past `end`, puts it. Returns this thread's new row.
__device__ __forceinline__ int shuffle_rows(int row, uint2 key, int start,
                                            int end, int t) {
  const uint2 order = warp_block_key(key, 1u, t);
  const int n = end - start, j = t - start;
  float u = __int_as_float(0x7F800000);
  if (j >= 0 && j < n) {
    u = uniform_of(block_bits(order.x, order.y, static_cast<uint32_t>(j)),
                   0.0f, 1.0f);
  }
  int rank = 0;
  for (int i = 0; i < n; ++i) {
    const float v = __shfl_sync(kWarp, u, start + i);
    rank += (v < u || (v == u && i < j)) ? 1 : 0;
  }
  int out = row;
  for (int i = 0; i < n; ++i) {
    const int to = __shfl_sync(kWarp, rank, start + i);
    const int from = __shfl_sync(kWarp, row, start + i);
    if (t == start + to) out = from;
  }
  return out;
}

// One warp a lane draws the scene of a generator tree (Shuffle,
// SampleGenerator, ChainGenerators over leaf-tree GenerateSprites) from its
// table (see kTreeHeader), as the generators' plain bodies draw it, but only
// the branch that the lane chose. The warp walks the tree depth first, a
// frame a composite node: a Shuffle's child from T(key, 0); a
// SampleGenerator's choice from T(key, 0) (randint, or choice over its
// cumulative sums), its chosen child from T(key, 1); a ChainGenerators'
// part i from T(key, i). A leaf draws its count (from T(key, 0), as the
// scene mode does) and appends its live slots at the cursor: thread p holds
// the scene's position p as (the leaf's order among the lane's leaves << 5
// | slot), and thread q the q-th leaf's sprites' key T(key, 1) and table.
// The rows of a chain's parts follow each other, so a chain's stable
// partition of live rows is the order of its leaves' appends; a
// SampleGenerator's padding and a scene's dead rows are the rows past the
// cursor; a Shuffle reorders its positions when its child is closed
// (shuffle_rows). The keys and counts of the walk are computed by thread 0
// and read by all. Then thread p writes the columns of row p that no draw
// writes (the whole default row past the cursor), and the warp's threads
// share the (position, leaf record) draws, each a record's draw from its
// slot's key T(sprites' key, slot), as the scene mode draws it. Every
// thread runs every loop the same number of times, so every shuffle sees
// the whole warp.
__global__ void __launch_bounds__(kTreeThreads)
lane_random_tree_kernel(const uint32_t* __restrict__ keys, long long lanes,
                        long long key_stride, const int* __restrict__ table,
                        float* __restrict__ factors, int* __restrict__ num,
                        bool* __restrict__ ok) {
  const long long lane =
      (static_cast<long long>(blockIdx.x) * kTreeThreads + threadIdx.x) >> 5;
  const int t = static_cast<int>(threadIdx.x & 31u);
  if (lane >= lanes) return;  // the whole warp
  const int kmax = __ldg(table + 1), width = __ldg(table + 2);
  const int most = __ldg(table + 3);
  const int* row_default = table + kTreeHeader;
  const int* nodes = row_default + width;
  int row = -1, leaf_word = 0, cursor = 0, leaves = 0;
  uint2 sprites = make_uint2(0u, 0u);
  int frame_node[kTreeMaxDepth], frame_next[kTreeMaxDepth];
  int frame_end[kTreeMaxDepth], frame_start[kTreeMaxDepth];
  uint2 frame_key[kTreeMaxDepth];
  int top = -1, node = 0;
  uint2 key = make_uint2(__ldg(keys + lane * key_stride),
                         __ldg(keys + lane * key_stride + 1));
  while (true) {
    const int* rec = nodes + node * kTreeRecord;
    const int kind = __ldg(rec);
    if (kind == kTreeLeaf) {
      const int word = __ldg(rec + 2);
      const uint32_t span = static_cast<uint32_t>(__ldg(table + word + 2));
      int count = __ldg(table + word + 1);
      uint2 s = make_uint2(0u, 0u);
      if (t == 0) {
        if (span != 0u) {
          const uint2 k = block_key(key, 0u);
          count = static_cast<int>(static_cast<uint32_t>(count) +
                                   randint_offset(k.x, k.y, 0u, span));
        }
        s = block_key(key, 1u);
      }
      count = __shfl_sync(kWarp, count, 0);
      s = make_uint2(__shfl_sync(kWarp, s.x, 0), __shfl_sync(kWarp, s.y, 0));
      if (t >= cursor && t < cursor + count) row = (leaves << 5) | (t - cursor);
      if (t == leaves) {
        sprites = s;
        leaf_word = word;
      }
      cursor += count;
      ++leaves;
    } else {
      ++top;
      frame_node[top] = node;
      frame_key[top] = key;
      frame_start[top] = cursor;
      frame_next[top] = 0;
      frame_end[top] = __ldg(rec + 1);
      if (kind == kTreeSample) {
        int c = 0;
        if (t == 0) {
          const uint2 k = block_key(key, 0u);
          const int n = __ldg(rec + 1), cum = __ldg(rec + 3);
          c = cum < 0 ? static_cast<int>(randint_offset(
                            k.x, k.y, 0u, static_cast<uint32_t>(n)))
                      : choice_of(k, table + cum, n);
        }
        c = __shfl_sync(kWarp, c, 0);
        frame_next[top] = c;
        frame_end[top] = c + 1;
      }
    }
    // Close the nodes whose children are drawn: a Shuffle orders its rows.
    while (top >= 0 && frame_next[top] >= frame_end[top]) {
      if (__ldg(nodes + frame_node[top] * kTreeRecord) == kTreeShuffle) {
        row = shuffle_rows(row, frame_key[top], frame_start[top], cursor, t);
      }
      --top;
    }
    if (top < 0) break;
    const int* parent = nodes + frame_node[top] * kTreeRecord;
    const int parent_kind = __ldg(parent), i = frame_next[top]++;
    node = __ldg(table + __ldg(parent + 2) + i);
    key = warp_block_key(
        frame_key[top],
        parent_kind == kTreeChain ? static_cast<uint32_t>(i)
                                  : (parent_kind == kTreeSample ? 1u : 0u),
        t);
  }
  float* out = factors + lane * kmax * width;
  const int word_of_row =
      __shfl_sync(kWarp, leaf_word, row >= 0 ? row >> 5 : 0);
  if (t < kmax) {
    float* r = out + t * width;
    if (t < cursor) {
      for (int m = __ldg(table + word_of_row + 3); m != 0; m &= m - 1) {
        const int c = __ffs(m) - 1;
        r[c] = __int_as_float(__ldg(row_default + c));
      }
    } else {
      for (int c = 0; c < width; ++c) {
        r[c] = __int_as_float(__ldg(row_default + c));
      }
    }
  }
  const int items = cursor * most;
  for (int base = 0; base < items; base += 32) {
    const int item = base + t;
    const int p = item < items ? item / most : 0;
    const int f = item - p * most;
    const int at = __shfl_sync(kWarp, row, p);
    const int q = at >= 0 ? at >> 5 : 0;
    const int word = __shfl_sync(kWarp, leaf_word, q);
    const uint2 s = make_uint2(__shfl_sync(kWarp, sprites.x, q),
                               __shfl_sync(kWarp, sprites.y, q));
    if (item < items && f < __ldg(table + word)) {
      const int* leaf = table + word;
      const int* rec = leaf + kSceneHeader + width + f * kSceneRecord;
      out[p * width + __ldg(rec + 1)] = draw_record(
          leaf, rec, block_key(s, static_cast<uint32_t>(at & 31)));
    }
  }
  if (t == 0) {
    num[lane] = cursor;
    ok[lane] = true;
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

// A `GenerateSprites` scene of `kmax` slots for each of `lanes` keys (lane
// l's at keys + l * key_stride) from the descriptor table `table` of
// `leaves` leaves on the card: factors f32[lanes, kmax, w] (w, the row's
// width, in the table), num i32[lanes], ok bool[lanes]. Launches on `stream`; returns the CUDA error
// code (0 on success).
extern "C" int lane_random_scene_launch(const uint32_t* keys,
                                        long long lanes,
                                        long long key_stride, int kmax,
                                        int leaves, const int* table,
                                        float* factors, int* num, bool* ok,
                                        void* stream) {
  if (lanes <= 0 || kmax <= 0) return 0;
  if (leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = lanes * kmax * (leaves > 0 ? leaves : 1);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  lane_random_scene_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      keys, lanes, key_stride, kmax, leaves, table, factors, num, ok);
  return static_cast<int>(cudaGetLastError());
}

// The scene of a generator tree for each of `lanes` keys (lane l's at keys +
// l * key_stride) from its table `table` on the card (see kTreeHeader):
// factors f32[lanes, kmax, w] (kmax and w in the table), num i32[lanes], ok
// bool[lanes]. Launches on `stream`; returns the CUDA error code (0 on
// success).
extern "C" int lane_random_tree_launch(const uint32_t* keys, long long lanes,
                                       long long key_stride,
                                       const int* table, float* factors,
                                       int* num, bool* ok, void* stream) {
  if (lanes <= 0) return 0;
  const long long blocks = (lanes * 32 + kTreeThreads - 1) / kTreeThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  lane_random_tree_kernel<<<static_cast<unsigned>(blocks), kTreeThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      keys, lanes, key_stride, table, factors, num, ok);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
