// Small-canvas rasterizer at anti_aliasing=1 for Hopper (sm_90a): a lane
// renders one canvas row of one scene, with no shared canvas.
//
// Replaces the TPU kernel `_fill_kernel` of
// spriteworld_tpu/ops/rasterize_pallas.py in its packed mode
// (`packed=True`, its pallas_call at the end of render_rgb_batch), which
// render_rgb_batch takes at anti_aliasing=1 for canvases narrower than 128
// pixels that divide 128 (64x64 among them: bench.py's default image64
// workload). It computes the same function as the scene kernel at
// anti_aliasing=1, from the same per-sprite tables
// (spriteworld_torch/ops/rasterize_cuda.py `prepare`): Pillow's exact
// scanline fill or the centroid fill of every sprite polygon, painted back
// to front, no downsample, and the vertical flip to math coordinates,
// written straight out as u8[B][h][w][3].
//
// What bounds it. At 64x64 a scene's output is 12 KiB, and of its ~8 KB of
// padded tables it needs ~1.7 KB (the scalars, `count` edges and `nf`
// features of its live sprites), so at 2048 scenes ~29 MB: ~0.0085 ms at
// 3.35 TB/s. The fill's operations (a crossing, a threshold and a few mask
// operations per edge and row) take a few microseconds at the float32
// rate. So the bound is the bytes; what the kernel pays in practice is the
// serial chain of each row's edges and its latency.
//
// Design. The canvas is at most 64 columns wide (the packed rule admits
// w = 1, 2, 4, ..., 64), so a canvas row's coverage is one 64-bit mask.
// * A lane owns a canvas row (a block of up to four warps owns a tile of
//   at most 128 rows of one scene, 64x64 being two warps). For each sprite
//   that reaches its row it first finds, by a compare pair an edge, the
//   edges whose row range holds the row (a bit each: V <= 32), then walks
//   only those, computing what `sw::fill_sprite` computes with the same
//   roundings: the crossing x0 + (r - y0) * m, Pillow's weight with the
//   bottom-duplicate rule, the odd-total trim of the row maximum (kept
//   aside while the walk goes on: an edge that is no longer the maximum
//   folds in at once; the masks depend only on the crossings and their
//   weights, so which of equal maxima loses the unit does not matter), and
//   the row's features. A crossing becomes exact integer column
//   thresholds: the first column c with x <= c - 0.5 (from floor(x) and
//   one compare, never ceil(x + 0.5), which would round), and its window
//   column. Their parities and windows are 64-bit masks. The centroid fill
//   is the same walk over the edges that straddle the row's centres, with
//   their divide. No warp collective is needed but a vote that skips a
//   sprite no row of the warp meets.
// * The painter's order lives in registers: the row's 64 slot bytes are
//   16 words, and each sprite's mask is spread to byte masks and blended
//   in, back to front, skipping the 16-column groups it misses. No shared
//   canvas, no zeroing, no barrier between sprites.
// * A block first stages the live sprites that reach its tile into shared
//   memory: their scalars as a header, then only their `count` edges (a
//   float4 and a float2 row range each) and `nf` features (a row and a
//   precomputed column mask), not the padded V = 30, so a warp's lanes
//   read each row range as one broadcast. The block's threads take the
//   records' items in one flat loop, so the loads go out together. Tables
//   larger than the staging budget go in chunks of sprites, in order.
// * Output: each slot byte reads its colour as one word (r, g, b in bytes
//   0-2) from a shared table, and four of them shift into 12 RGB bytes.
//   A lane writes its row to its warp's buffer (the records' region, once
//   the rows are filled), and the warp stores 16 rows' contiguous bytes of
//   the flipped image from it, neighbouring lanes on neighbouring 16-byte
//   chunks (bytes when 3w is no multiple of 16: w < 16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fill.cuh"

namespace {

using namespace sw;

typedef unsigned long long u64;

constexpr int kMaxWarps = 4;
constexpr int kMaxThreads = 32 * kMaxWarps;  // also the most rows a tile
// Blocks of kMaxThreads an SM that the register budget must allow: at most
// 64 registers a thread, so 16 blocks of two warps (a 64x64 scene each)
// fit an SM and 2048 scenes run in one wave; left free, the compiler takes
// 94 and two waves.
constexpr int kMinBlocks = 8;
constexpr int kWords = 16;  // slot words of a canvas row of <= 64 pixels
// A staged sprite: a header of kHeader words by sprite, and a record in
// its chunk: `count` float4 edges, their `count` float2 row ranges (rounded
// up to 4 words) and `nf` int4 features.
constexpr int kHeader = 8;
enum { H_SLOT, H_COUNT, H_NF, H_ROW0, H_ROW1, H_CMASK_LO, H_CMASK_HI,
       H_GYMAX };
constexpr int kStageWordsMax = 2560;  // 10 KiB of records a block
// A warp's output buffer: 16 rows of whole groups of 16 pixels (48 bytes)
// at a pitch of one group more than the row's 16 bytes (its 16-byte loads
// of eight lanes meet distinct banks at w = 64).
constexpr int kOutRows = 16;
constexpr int kOutBufWords = kOutRows * (3 * 64 + 16) / 4;

__host__ __device__ inline int out_pitch(int w) {
  return 48 * ((w + 15) / 16) + 16;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int record_words(int count, int nf) {
  return 4 * count + round4(2 * count) + 4 * nf;
}

__host__ __device__ inline int threads_of(int tile_rows) {
  const int warps = (tile_rows + 31) / 32;
  return 32 * (warps < kMaxWarps ? warps : kMaxWarps);
}

// The records' region: every sprite's largest record up to kStageWordsMax
// (larger tables go in chunks), and at least the warps' output buffers,
// which reuse it once a pass's rows are filled.
__host__ __device__ inline int stage_words(int K, int V, int threads) {
  const int most = K * record_words(V, 2 * V);
  const int records = most < kStageWordsMax ? most : kStageWordsMax;
  const int out = threads / 32 * kOutBufWords;
  return records > out ? records : out;
}

struct Layout {
  // Byte offsets of the plan (headers, sizes, staged order, offsets, item
  // starts, chunk starts) and of the records; the colour words come
  // first.
  size_t plan, stage, bytes;
};

__host__ __device__ inline Layout layout(int K, int V, int threads) {
  Layout L;
  L.plan = round16(size_t(K + 1) * 4);
  L.stage = L.plan + round16(size_t((kHeader + 5) * K + 3) * 4);
  L.bytes = L.stage + size_t(stage_words(K, V, threads)) * 4;
  return L;
}

// A staged record's parts (see kHeader).
struct Record {
  float4* edges;  // exact: y0, m, x0, ymax; centroid: y0, dy, x0, dx
  float2* range;  // rows: exact [ymin, ymax]; centroid [min y, max y)
  int4* feats;    // row, column mask
};

__device__ __forceinline__ Record record_at(int* base, int count) {
  Record R;
  R.edges = reinterpret_cast<float4*>(base);
  R.range = reinterpret_cast<float2*>(base + 4 * count);
  R.feats = reinterpret_cast<int4*>(base + 4 * count + round4(2 * count));
  return R;
}

// Columns c >= t of a row.
__device__ __forceinline__ u64 cols_from(int t) {
  return t <= 0 ? ~0ull : (t >= 64 ? 0ull : ~0ull << t);
}

// Columns a..b.
__device__ __forceinline__ u64 col_range(int a, int b) {
  return a > b ? 0ull : cols_from(a) & ~cols_from(b + 1);
}

// Folds a crossing x of weight w into a row's masks: the weight's parity
// flips the columns c with x <= c - 0.5 (from t, the first of them), and a
// weight marks the window column c - 0.5 < x < c + 0.5 (t - 1, none when x
// lies on a pixel boundary). floor(x) is exact, and so are f + 0.5 and the
// compares, as long as f is clamped to a few columns past the row.
__device__ __forceinline__ void fold(float x, int w, u64& parity,
                                     u64& window) {
  const float f = fminf(fmaxf(floorf(x), -2.f), 65.f);
  const float half = f + 0.5f;
  const int t = static_cast<int>(f) + (x <= half ? 1 : 2);
  const u64 from = cols_from(t);
  parity ^= (w & 1) ? from : 0ull;
  const int s = t - 1;
  window |= (w > 0 && x != half && s >= 0 && s < 64) ? 1ull << s : 0ull;
}

// The columns of canvas row `rf` that Pillow's exact fill paints for a
// staged sprite, before its column bounds. The lane first finds the edges
// whose row range holds its row (a compare pair each), then walks only
// those: the others weigh nothing. The masks depend only on the crossings
// and their weights, and the row maximum is held aside for the trim.
__device__ __forceinline__ u64 exact_row(const int* head, const Record& R,
                                         float rf, int r) {
  const int count = head[H_COUNT];
  const float gymax = __int_as_float(head[H_GYMAX]);
  unsigned hits = 0u;
  for (int e = 0; e < count; ++e) {
    const float2 Y = R.range[e];
    hits |= (rf >= Y.x && rf <= Y.y) ? 1u << e : 0u;
  }
  u64 parity = 0ull, window = 0ull;
  int total = 0, hw = 0;  // the row maximum so far, held aside
  float hx = -kBig;
  for (; hits; hits &= hits - 1u) {
    const int e = __ffs(hits) - 1;
    const float4 E = R.edges[e];  // y0, m, x0, ymax
    const float ymx = E.w;
    const int w = 1 + static_cast<int>(rf == ymx && ymx < gymax);
    total += w;
    const float xi =
        pillow_crossing(__fadd_rn(E.z, __fmul_rn(__fsub_rn(rf, E.x), E.y)));
    const bool top = xi > hx;
    const float fx = top ? hx : xi;  // the crossing that folds in now
    const int fw = top ? hw : w;
    hx = top ? xi : hx;
    hw = top ? w : hw;
    fold(fx, fw, parity, window);
  }
  // Odd-total trim: one instance of the maximum goes.
  fold(hx, hw - (total & 1), parity, window);
  u64 on = 0ull;
  for (int j = 0; j < head[H_NF]; ++j) {
    const int4 F = R.feats[j];
    if (F.x == r)
      on |= (static_cast<u64>(static_cast<unsigned>(F.z)) << 32)
            | static_cast<unsigned>(F.y);
  }
  return parity | window | on;
}

// The centroid fill's columns of canvas row `rf` (points_in_polygons at
// pixel centres, with its roundings): each edge that straddles the centre
// row (min y <= py < max y, the same test as (y0 > py) != (y1 > py)) has
// its crossing x flip the columns c with c + 0.5 < x, those below floor(x)
// and floor(x) itself when floor(x) + 0.5 < x.
__device__ __forceinline__ u64 centroid_row(const int* head, const Record& R,
                                            float rf) {
  const int count = head[H_COUNT];
  const float py = __fadd_rn(rf, 0.5f);
  unsigned hits = 0u;
  for (int e = 0; e < count; ++e) {
    const float2 Y = R.range[e];
    hits |= (Y.x <= py && py < Y.y) ? 1u << e : 0u;
  }
  u64 inside = 0ull;
  for (; hits; hits &= hits - 1u) {
    const float4 E = R.edges[__ffs(hits) - 1];  // y0, dy, x0, dx
    const float x =
        __fadd_rn(E.z, __fmul_rn(__fdiv_rn(__fsub_rn(py, E.x), E.y), E.w));
    const float f = fminf(fmaxf(floorf(x), -2.f), 65.f);
    const int u = static_cast<int>(f) + (x > f + 0.5f ? 1 : 0);
    inside ^= ~cols_from(u);
  }
  return inside;
}

// Paints slot `value` into the columns of `m`: bit c of the mask is byte
// c & 3 of word c >> 2. Groups of 16 columns that `m` misses are skipped.
__device__ __forceinline__ void paint(unsigned (&slots)[kWords], u64 m,
                                      unsigned value) {
  const unsigned rep = value * 0x01010101u;
#pragma unroll
  for (int g = 0; g < kWords / 4; ++g) {
    const unsigned bits = static_cast<unsigned>(m >> (16 * g)) & 0xffffu;
    if (bits == 0u) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned nib = (bits >> (4 * q)) & 15u;
      // Bits 0-3 to bytes 0-3 (shifts 0, 7, 14, 21 do not overlap).
      const unsigned bm = ((nib * 0x00204081u) & 0x01010101u) * 255u;
      slots[4 * g + q] = (slots[4 * g + q] & ~bm) | (rep & bm);
    }
  }
}

// Writes a row of w pixels from its slot words to `orow` (16-byte aligned),
// in whole groups of 16 (the columns past w hold the background): each
// slot's colour word r | g << 8 | b << 16 from `rgb`, four of them shifted
// into 12 bytes r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3; sixteen pixels
// are three 16-byte stores.
__device__ __forceinline__ void write_row(const unsigned (&slots)[kWords],
                                          int w, const unsigned* rgb,
                                          uint8_t* orow) {
#pragma unroll
  for (int g = 0; g < kWords / 4; ++g) {
    if (16 * g < w) {
      unsigned o[12];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned s = slots[4 * g + q];
        const unsigned p0 = rgb[s & 255u], p1 = rgb[(s >> 8) & 255u];
        const unsigned p2 = rgb[(s >> 16) & 255u], p3 = rgb[s >> 24];
        o[3 * q] = p0 | (p1 << 24);
        o[3 * q + 1] = (p1 >> 8) | (p2 << 16);
        o[3 * q + 2] = (p2 >> 16) | (p3 << 8);
      }
      uint4* dst = reinterpret_cast<uint4*>(orow + 48 * g);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      dst[2] = make_uint4(o[8], o[9], o[10], o[11]);
    }
  }
}

// Stores `nrows` rows of `row_bytes` bytes from a warp's buffer (rows
// `pitch` apart, the last first: the flip) to `dst`, where they lie
// contiguous, in units of T (row_bytes and dst a multiple of its size),
// neighbouring lanes on neighbouring units.
template <typename T>
__device__ __forceinline__ void store_rows(const uint8_t* buf, int pitch,
                                           int nrows, int row_bytes,
                                           uint8_t* dst, int lane) {
  const int per = row_bytes / static_cast<int>(sizeof(T));
  T* d = reinterpret_cast<T*>(dst);
  for (int q = lane; q < nrows * per; q += 32) {
    const int ir = q / per;  // image row within the run
    d[q] = *reinterpret_cast<const T*>(buf + (nrows - 1 - ir) * pitch
                                       + (q - ir * per) * sizeof(T));
  }
}

// Stages the planned sprites [i0, i1) into their records: edges and
// features, the block's threads taking the items (`s_first` from sprite
// i's on) in one flat loop, so that their loads go out together.
__device__ __forceinline__ void stage_chunk(
    const float* scene_tab, int V, int NT, int centroid, const int* s_head,
    const int* s_list, const int* s_off, const int* s_first, int i0, int i1,
    int* stage, int tid, int nthreads) {
  for (int q = s_first[i0] + tid; q < s_first[i1]; q += nthreads) {
    int lo = i0, hi = i1 - 1;  // the sprite whose items hold q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_first[mid] <= q) lo = mid;
      else hi = mid - 1;
    }
    const int k = s_list[lo];
    const int count = s_head[kHeader * k + H_COUNT];
    const int e = q - s_first[lo];
    const float* st = scene_tab + size_t(k) * NT + kNumScalars;
    const Record R = record_at(stage + s_off[lo], count);
    if (e < count) {
      const float* f = st + e;
      const float a = f[0], b = f[V], c = f[2 * V], d = f[3 * V];
      const float t = f[4 * V];
      if (centroid) {  // y0, dy, x0, y1, dx
        R.edges[e] = make_float4(a, b, c, t);
        R.range[e] = make_float2(fminf(a, d), fmaxf(a, d));
      } else {  // y0, m, x0, ymin, ymax
        R.edges[e] = make_float4(a, b, c, t);
        R.range[e] = make_float2(d, t);
      }
      continue;
    }
    const int j = e - count;
    const float* fj = st + 5 * V + 3 * j;
    const float row = fj[0];
    // Columns lo <= c <= hi: from ceil(lo) to floor(hi).
    const float a = fminf(fmaxf(ceilf(fj[1]), 0.f), 64.f);
    const float b = fminf(fmaxf(floorf(fj[2]), -1.f), 63.f);
    const u64 cm = col_range(static_cast<int>(a), static_cast<int>(b));
    // A row that is no integer meets no canvas row.
    const int ri = row == floorf(row) && fabsf(row) < 1e9f
                       ? static_cast<int>(row) : -(1 << 30);
    R.feats[j] = make_int4(ri, static_cast<int>(static_cast<unsigned>(cm)),
                           static_cast<int>(static_cast<unsigned>(cm >> 32)),
                           0);
  }
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
packed_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                     int h, int w, int centroid, int tile_rows,
                     int num_tiles, int bg_packed,
                     uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(K, V, nthreads);
  unsigned* rgb = reinterpret_cast<unsigned*>(smem);  // [K + 1]
  int* s_head = reinterpret_cast<int*>(smem + L.plan);  // [K][kHeader]
  int* s_size = s_head + kHeader * K;  // [K] record words
  int* s_list = s_size + K;    // [K] staged sprites, in order
  int* s_off = s_list + K;     // [K] their record offsets in their chunk
  int* s_first = s_off + K;    // [K + 1] their first item, in order
  int* s_chunk = s_first + K + 1;  // [K + 1] first staged index a chunk
  int* s_nchunks = s_chunk + K + 1;
  int* stage = reinterpret_cast<int*>(smem + L.stage);
  const int budget = stage_words(K, V, nthreads);

  const int scene = blockIdx.x / num_tiles;
  const int row_begin = (blockIdx.x - scene * num_tiles) * tile_rows;
  const int rows = min(tile_rows, h - row_begin);
  const int row_last = row_begin + rows - 1;
  const float* scene_tab = tab + size_t(scene) * K * NT;

  for (int i = tid; i <= K; i += nthreads) {
    const int c = i == 0 ? bg_packed
                         : static_cast<int>(scene_tab[(i - 1) * NT + T_COLOR]);
    rgb[i] = ((c >> 16) & 255) | (c & 0xff00) | ((c & 255) << 16);
  }
  // Sprite culling: a live sprite whose rows reach the tile gets a header
  // and a record.
  for (int k = tid; k < K; k += nthreads) {
    const float* st = scene_tab + size_t(k) * NT;
    const int count = static_cast<int>(st[T_COUNT]);
    const int nf = static_cast<int>(st[T_NF]);
    const int row0 = static_cast<int>(st[T_ROW0]);
    const int row1 = static_cast<int>(st[T_ROW1]);
    const u64 cm = col_range(max(static_cast<int>(st[T_COL0]), 0),
                             min(static_cast<int>(st[T_COL1]), w - 1));
    int* head = s_head + kHeader * k;
    head[H_SLOT] = k + 1;
    head[H_COUNT] = count;
    head[H_NF] = nf;
    head[H_ROW0] = row0;
    head[H_ROW1] = row1;
    head[H_CMASK_LO] = static_cast<int>(static_cast<unsigned>(cm));
    head[H_CMASK_HI] = static_cast<int>(static_cast<unsigned>(cm >> 32));
    head[H_GYMAX] = __float_as_int(st[T_GYMAX]);
    const bool meets = count > 0 && row0 <= row_last && row1 >= row_begin;
    s_size[k] = meets ? record_words(count, nf) : 0;
  }
  __syncthreads();
  if (tid == 0) {  // chunks of records that fit the budget, in order
    int n = 0, nch = 0, used = budget + 1, items = 0;
    for (int k = 0; k < K; ++k) {
      const int size = s_size[k];
      if (size == 0) continue;
      if (used + size > budget) {
        s_chunk[nch++] = n;
        used = 0;
      }
      s_list[n] = k;
      s_off[n] = used;
      s_first[n] = items;
      used += size;
      items += s_head[kHeader * k + H_COUNT] + s_head[kHeader * k + H_NF];
      ++n;
    }
    s_first[n] = items;
    s_chunk[nch] = n;
    *s_nchunks = nch;
  }
  __syncthreads();
  const int nchunks = *s_nchunks;

  // A thread renders canvas row r (image row h - 1 - r) in its slot words.
  const int r = row_begin + tid;
  const bool active = r <= row_last;
  const float rf = static_cast<float>(r);
  unsigned slots[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) slots[i] = 0u;
  for (int c = 0; c < nchunks; ++c) {
    if (c > 0) __syncthreads();  // the last chunk's readers are done
    stage_chunk(scene_tab, V, NT, centroid, s_head, s_list, s_off, s_first,
                s_chunk[c], s_chunk[c + 1], stage, tid, nthreads);
    __syncthreads();
    for (int i = s_chunk[c]; i < s_chunk[c + 1]; ++i) {
      const int* head = s_head + kHeader * s_list[i];
      const bool in = active && r >= head[H_ROW0] && r <= head[H_ROW1];
      if (!__any_sync(kFull, in)) continue;
      const Record R = record_at(stage + s_off[i], head[H_COUNT]);
      u64 m = centroid ? centroid_row(head, R, rf)
                       : exact_row(head, R, rf, r);
      m &= (static_cast<u64>(static_cast<unsigned>(head[H_CMASK_HI])) << 32)
           | static_cast<unsigned>(head[H_CMASK_LO]);
      paint(slots, in ? m : 0ull, static_cast<unsigned>(head[H_SLOT]));
    }
  }
  // Each warp writes its rows through its buffer (the records' region,
  // once every warp is done with them), 16 rows at a time: a lane writes
  // its row there, then the warp stores the rows' contiguous bytes of the
  // flipped image.
  __syncthreads();
  uint8_t* buf = reinterpret_cast<uint8_t*>(stage + warp * kOutBufWords);
  const int pitch = out_pitch(w), row_bytes = 3 * w;
  for (int half = 0; half < 2; ++half) {
    const int base = row_begin + 32 * warp + kOutRows * half;
    const int nrows = min(max(row_last - base + 1, 0), kOutRows);
    if ((lane >> 4) == half && active)
      write_row(slots, w, rgb, buf + (lane & 15) * pitch);
    __syncwarp();
    uint8_t* dst = out + (size_t(scene) * h + (h - base - nrows)) * row_bytes;
    if (row_bytes % 16 == 0)
      store_rows<uint4>(buf, pitch, nrows, row_bytes, dst, lane);
    else  // w < 16
      store_rows<uint8_t>(buf, pitch, nrows, row_bytes, dst, lane);
    __syncwarp();
  }
}

}  // namespace

// Shared memory a packed_raster block of tiles of `tile_rows` rows needs;
// the wrapper's Python mirror (rasterize_cuda.packed_smem_bytes) is held
// equal to it.
extern "C" long long packed_raster_smem_bytes(int K, int V, int tile_rows) {
  return static_cast<long long>(layout(K, V, threads_of(tile_rows)).bytes);
}

// Blocks of `tile_rows` rows and `smem_bytes` of shared memory resident on
// one SM (registers, threads and shared memory together).
extern "C" int packed_raster_blocks_per_sm(long long smem_bytes,
                                           int tile_rows) {
  int blocks = 0;
  cudaFuncSetAttribute(packed_raster_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, packed_raster_kernel, threads_of(tile_rows),
      static_cast<size_t>(smem_bytes));
  return blocks;
}

// The image at anti_aliasing=1 of B scenes of h x w pixels (w <= 64), in
// tiles of `tile_rows` rows (at most kMaxThreads); `centroid` selects the
// fill. Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int packed_raster_launch(const float* tab, int B, int K, int V,
                                    int NT, int h, int w, int centroid,
                                    int tile_rows, int bg_packed,
                                    uint8_t* out, void* stream) {
  if (w > 64 || tile_rows < 1 || tile_rows > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_of(tile_rows);
  const Layout L = layout(K, V, threads);
  cudaError_t err = cudaFuncSetAttribute(
      packed_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles = (h + tile_rows - 1) / tile_rows;
  packed_raster_kernel<<<B * num_tiles, threads, L.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      tab, K, V, NT, h, w, centroid, tile_rows, num_tiles, bg_packed, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
