// The two polygon fills of one sprite, shared by the scene kernel
// (scene_raster.cu) and the row-strip kernel (strip_raster.cu), with the
// table layout that the small anti_aliasing=1 kernel (packed_raster.cu,
// which fills a row its own way) reads too; the slot resolution that the
// box filter and the Lanczos passes (lanczos_mma.cuh) share; and the box
// filter by words (`box_words`) with the sprite-bounds test that lets the
// scene and strip kernels skip the canvas where no sprite reaches.
//
// Inputs are one sprite's row of the packed table of
// spriteworld_torch/ops/rasterize_cuda.py (`prepare`): 8 scalars, 5 edge
// fields of V values, then 2V features (row, lo, hi). The exact fill's
// tables hold (y0, m, x0, ymin, ymax) per edge; the centroid fill's hold
// (y0, dy, x0, y1, dx) and no features.
//
// `fill_sprite` is Pillow's exact fill. Canvas row r belongs to warp
// r % num_warps, and lane e holds edge e. For
// each row the warp computes xi = x0 + (r - y0) * m with __fmul_rn/__fadd_rn
// (two roundings, as Pillow; nvcc would otherwise contract to an FMA), the
// edge's Pillow weight with the bottom-duplicate rule, and by warp
// reductions the row's total weight and its first maximum crossing: the
// odd-total trim drops one instance of it. The warp then compacts the edges
// left with a weight (a row crosses a simple polygon at two, mostly) by
// ballot, into every lane's registers by shuffle (up to kRegCrossings) or
// else its shared scratch, and finds the row's features by ballot, so that
// each lane fills the columns of the sprite's bounds from those alone:
// odd(sum of weights with xi <= c - 0.5) or some weight with c - 0.5 < xi <
// c + 0.5, or a horizontal-edge/wedge feature interval on this row. Integer
// weights and unchanged crossings give the same pixels in any order. A row
// is only ever written by its own warp, so the painter's order needs no
// block barrier between sprites. `wc` is the canvas pitch in bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sw {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

// Table layout (rasterize_cuda.py).
constexpr int kNumScalars = 8;
enum { T_COUNT, T_NF, T_COLOR, T_GYMAX, T_ROW0, T_ROW1, T_COL0, T_COL1 };
enum { E_Y0, E_M, E_X0, E_YMIN, E_YMAX };
enum { C_Y0, C_DY, C_X0, C_Y1, C_DX };

// Downsample modes of the kernels (rasterize_cuda.py's DS_* constants).
enum { DS_IDENTITY = 0, DS_LANCZOS = 1, DS_BOX = 2 };

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Pillow's clip8 of an int32 fixed-point accumulator (taps q / 2^22).
__device__ __forceinline__ uint8_t clip8(int acc) {
  const int v = acc >> 22;  // arithmetic shift: floor division by 2^22
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---- Slot resolution, shared by the box filter below and the Lanczos
// passes (lanczos_mma.cuh). Each channel's colour table is
// `chan[ch * kc + slot]`, kc = chan_stride(K). With K + 1 <= 8 slots one
// channel's table sits in two registers and one byte permute maps four slots
// at once (kRoute8); with K + 1 <= 16, two permutes and a byte blend
// (kRoute16); above that, one shared-memory load per byte (kRouteTable).
enum { kRoute8 = 0, kRoute16 = 1, kRouteTable = 2 };

// Bytes per channel of the colour table `chan`: K + 1 slots rounded up to
// 16, so the two register routes read whole words.
__host__ __device__ inline int chan_stride(int K) {
  return (K + 1 + 15) & ~15;
}

// One channel's colour table in registers: slots 0-15, four a word.
struct ChanRegs {
  unsigned w[3][4];
};

__device__ __forceinline__ void load_chan_regs(ChanRegs& r,
                                               const uint8_t* chan, int kc) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i)  // kc >= 16
      r.w[ch][i] = reinterpret_cast<const unsigned*>(chan + ch * kc)[i];
}

// Four slot bytes `s` -> their four channel-`ch` bytes.
template <int kRoute>
__device__ __forceinline__ unsigned resolve(unsigned s, int ch,
                                            const ChanRegs& r,
                                            const uint8_t* chan, int kc) {
  if (kRoute == kRouteTable) {
    const uint8_t* c = chan + ch * kc;
    return c[s & 255u] | (c[(s >> 8) & 255u] << 8)
           | (c[(s >> 16) & 255u] << 16) | (static_cast<unsigned>(c[s >> 24])
                                            << 24);
  }
  // Selector nibbles b0 | b1 << 4 | b2 << 8 | b3 << 12 of the slot bytes.
  const unsigned t = s | (s >> 4);
  const unsigned sel = __byte_perm(t, 0u, 0x0020u) & 0x7777u;
  if (kRoute == kRoute8) return __byte_perm(r.w[ch][0], r.w[ch][1], sel);
  const unsigned lo = __byte_perm(r.w[ch][0], r.w[ch][1], sel);
  const unsigned hi = __byte_perm(r.w[ch][2], r.w[ch][3], sel);
  const unsigned m = ((s >> 3) & 0x01010101u) * 0xffu;  // slots >= 8
  return (lo & ~m) | (hi & m);
}

// Crossings a row keeps in registers in `fill_sprite`; rows with more use
// the warp's shared scratch.
constexpr int kRegCrossings = 4;

// A scanline crossing as the fill counts it (rasterize.pillow_crossing):
// -0.5 becomes the float just above it. Pillow rounds a negative half away
// from zero, so a span that ends at -0.5 ends at column 0: the nudged
// crossing lies in column 0's window, and every column from 1 on counts it
// as before.
__device__ __forceinline__ float pillow_crossing(float x) {
  return x == -0.5f ? -0.49999997f : x;
}

// Whether column `cf` lies in one of the row's features: those of the
// ballots f_lo (features 0-31) and f_hi (32-63).
__device__ __forceinline__ bool on_feature(const float* feat, unsigned f_lo,
                                           unsigned f_hi, float cf) {
  for (unsigned f = f_lo; f; f &= f - 1u) {
    const float* fj = feat + 3 * (__ffs(f) - 1);
    if (fj[1] <= cf && cf <= fj[2]) return true;
  }
  for (unsigned f = f_hi; f; f &= f - 1u) {
    const float* fj = feat + 3 * (__ffs(f) + 31);
    if (fj[1] <= cf && cf <= fj[2]) return true;
  }
  return false;
}

// Paints slot index `value` into every pixel of sprite table row `st` that
// Pillow fills, over canvas rows [r0, r1] and columns [c0, c1] (clipped by
// the caller). `canvas` holds rows from `row_base` on, `wc` bytes each. `wx`
// and `ww` are this warp's 32-entry scratch. The sprite must be live
// (count > 0); every lane of the warp calls this.
__device__ __forceinline__ void fill_sprite(
    const float* st, int V, uint8_t value, int r0, int r1, int c0, int c1,
    int row_base, uint8_t* canvas, int wc, float* wx, int* ww, int warp,
    int num_warps, int lane) {
  const int count = static_cast<int>(st[T_COUNT]);
  const int nf = static_cast<int>(st[T_NF]);
  const float gymax = st[T_GYMAX];
  const float* feat = st + kNumScalars + 5 * V;
  const bool has_edge = lane < count;
  const float y0 = has_edge ? st[kNumScalars + E_Y0 * V + lane] : 0.f;
  const float m = has_edge ? st[kNumScalars + E_M * V + lane] : 0.f;
  const float x0 = has_edge ? st[kNumScalars + E_X0 * V + lane] : 0.f;
  const float ymn = has_edge ? st[kNumScalars + E_YMIN * V + lane] : kBig;
  const float ymx = has_edge ? st[kNumScalars + E_YMAX * V + lane] : -kBig;
  const unsigned below = (1u << lane) - 1u;

  const int first_row =
      r0 + ((warp - r0) % num_warps + num_warps) % num_warps;
  for (int r = first_row; r <= r1; r += num_warps) {
    const float rf = static_cast<float>(r);
    const float xi =
        pillow_crossing(__fadd_rn(x0, __fmul_rn(__fsub_rn(rf, y0), m)));
    const bool inr = rf >= ymn && rf <= ymx;
    const bool dup = inr && rf == ymx && ymx < gymax;
    int wgt = static_cast<int>(inr) + static_cast<int>(dup);
    // Odd-total trim: drop one instance of the first row maximum.
    const int total = __reduce_add_sync(kFull, wgt);
    float rmax = wgt > 0 ? xi : -kBig;
    for (int o = 16; o > 0; o >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, o));
    const unsigned ismax = __ballot_sync(kFull, wgt > 0 && xi == rmax);
    if ((total & 1) && lane == __ffs(ismax) - 1) wgt -= 1;
    // The row's crossings: the edges left with a weight (a row crosses a
    // simple polygon at two, mostly), compacted by ballot; and its
    // features, found by ballot (nf <= 2V <= 64).
    const unsigned hits = __ballot_sync(kFull, wgt > 0);
    const unsigned f_lo =
        __ballot_sync(kFull, lane < nf && feat[3 * lane] == rf);
    const unsigned f_hi =
        __ballot_sync(kFull, lane + 32 < nf && feat[3 * (lane + 32)] == rf);
    if (hits == 0u && (f_lo | f_hi) == 0u) continue;  // uniform: nothing here
    const int n = __popc(hits);
    uint8_t* crow = canvas + size_t(r - row_base) * wc;
    if (n <= kRegCrossings) {
      // Up to four crossings go to every lane's registers by shuffle.
      float xr[kRegCrossings];
      int wr[kRegCrossings];
      unsigned rest = hits;
#pragma unroll
      for (int i = 0; i < kRegCrossings; ++i) {
        const int src = rest ? __ffs(rest) - 1 : 0;
        xr[i] = __shfl_sync(kFull, xi, src);
        wr[i] = rest ? __shfl_sync(kFull, wgt, src) : 0;
        rest &= rest - 1u;
      }
      for (int c = c0 + lane; c <= c1; c += 32) {
        const float cf = static_cast<float>(c);
        const float cm = cf - 0.5f, cp = cf + 0.5f;
        int le = 0, win = 0;
#pragma unroll
        for (int i = 0; i < kRegCrossings; ++i) {
          le += xr[i] <= cm ? wr[i] : 0;
          win += (!(xr[i] <= cm) && xr[i] < cp) ? wr[i] : 0;
        }
        if ((le & 1) || win > 0 || on_feature(feat, f_lo, f_hi, cf))
          crow[c] = value;
      }
      continue;
    }
    __syncwarp();
    if (wgt > 0) {
      const int i = __popc(hits & below);
      wx[i] = xi;
      ww[i] = wgt;
    }
    __syncwarp();
    for (int c = c0 + lane; c <= c1; c += 32) {
      const float cf = static_cast<float>(c);
      const float cm = cf - 0.5f, cp = cf + 0.5f;
      int le = 0, win = 0;
      for (int e = 0; e < n; ++e) {
        const float x = wx[e];
        if (x <= cm) le += ww[e];
        else if (x < cp) win += ww[e];
      }
      if ((le & 1) || win > 0 || on_feature(feat, f_lo, f_hi, cf))
        crow[c] = value;
    }
  }
}

// The centroid fill (pil_exact=False): pixel (r, c) is filled when the
// point (c + 0.5, r + 0.5) lies inside the polygon by the even-odd rule of
// ops/geometry.py::points_in_polygons, computed with its roundings: edge e
// from (x0, y0) to (x0 + dx, y1) straddles row r when (y0 > py) != (y1 >
// py), and crosses it at x = x0 + ((py - y0) / dy) * dx (a subtract, a
// divide, a multiply and an add, each rounded once); the pixel counts it
// when c + 0.5 < x. Edges past the vertex count and dead slots have y1 ==
// y0 and never straddle. Same ownership as fill_sprite: canvas row r
// belongs to warp r % num_warps, lane e computes edge e's crossing, and the
// warp compacts the straddling crossings (a row crosses a simple polygon at
// two of them, mostly) into its lanes' registers by shuffle, or into `wx`
// past kRegCrossings, before its lanes test the columns.
__device__ __forceinline__ void fill_sprite_centroid(
    const float* st, int V, uint8_t value, int r0, int r1, int c0, int c1,
    int row_base, uint8_t* canvas, int wc, float* wx, int warp,
    int num_warps, int lane) {
  const int count = static_cast<int>(st[T_COUNT]);
  const bool has_edge = lane < count;
  const float y0 = has_edge ? st[kNumScalars + C_Y0 * V + lane] : 0.f;
  const float dy = has_edge ? st[kNumScalars + C_DY * V + lane] : 1.f;
  const float x0 = has_edge ? st[kNumScalars + C_X0 * V + lane] : 0.f;
  const float y1 = has_edge ? st[kNumScalars + C_Y1 * V + lane] : 0.f;
  const float dx = has_edge ? st[kNumScalars + C_DX * V + lane] : 0.f;
  const unsigned below = (1u << lane) - 1u;

  const int first_row =
      r0 + ((warp - r0) % num_warps + num_warps) % num_warps;
  for (int r = first_row; r <= r1; r += num_warps) {
    const float py = __fadd_rn(static_cast<float>(r), 0.5f);
    const bool straddle = has_edge && ((y0 > py) != (y1 > py));
    const unsigned hits = __ballot_sync(kFull, straddle);
    if (hits == 0u) continue;  // uniform across the warp
    const float x =
        __fadd_rn(x0, __fmul_rn(__fdiv_rn(__fsub_rn(py, y0), dy), dx));
    const int n = __popc(hits);
    uint8_t* crow = canvas + size_t(r - row_base) * wc;
    if (n <= kRegCrossings) {  // in every lane's registers, by shuffle
      float xr[kRegCrossings];
      unsigned rest = hits;
#pragma unroll
      for (int i = 0; i < kRegCrossings; ++i) {
        const float xs = __shfl_sync(kFull, x, rest ? __ffs(rest) - 1 : 0);
        xr[i] = rest ? xs : -kBig;  // never right of a pixel centre
        rest &= rest - 1u;
      }
      for (int c = c0 + lane; c <= c1; c += 32) {
        const float px = __fadd_rn(static_cast<float>(c), 0.5f);
        int inside = 0;
#pragma unroll
        for (int i = 0; i < kRegCrossings; ++i) inside ^= px < xr[i];
        if (inside) crow[c] = value;
      }
      continue;
    }
    __syncwarp();
    if (straddle) wx[__popc(hits & below)] = x;
    __syncwarp();
    for (int c = c0 + lane; c <= c1; c += 32) {
      const float px = __fadd_rn(static_cast<float>(c), 0.5f);
      int inside = 0;
      for (int e = 0; e < n; ++e) inside ^= px < wx[e];
      if (inside) crow[c] = value;
    }
  }
}

// Bytes 0 .. n - 1 of a little-endian word (n clamped to [0, 4]): the
// high word of 0x00000000ffffffff shifted left by 8n bits, clamped at 32.
__device__ __forceinline__ unsigned low_bytes(int n) {
  return __funnelshift_lc(0xffffffffu, 0u, 8 * max(n, 0));
}

// Bit k: sprite k (k < 32) of the table `tab` (rows of NT floats) is live
// and its row bounds reach canvas rows [row_lo, row_hi]. Every bit when K >
// 32, which marks every column as met below. Every warp lane calls this.
__device__ __forceinline__ unsigned sprites_on_rows(const float* tab, int K,
                                                    int NT, int row_lo,
                                                    int row_hi, int lane) {
  if (K > 32) return kFull;
  const float* st = tab + lane * NT;
  return __ballot_sync(kFull, lane < K && st[T_COUNT] > 0.f
                                  && st[T_ROW0] <= row_hi
                                  && st[T_ROW1] >= row_lo);
}

// Whether canvas columns [a, b] meet the column bounds of a sprite of `on`
// (sprites_on_rows). A pixel outside every sprite's bounds is background.
__device__ __forceinline__ bool columns_meet(const float* tab, int NT,
                                             unsigned on, int a, int b) {
  if (on == kFull) return true;
  for (unsigned m = on; m; m &= m - 1u) {
    const float* st = tab + (__ffs(m) - 1) * NT;
    if (st[T_COL0] <= b && st[T_COL1] >= a) return true;
  }
  return false;
}

// One slot's colour (packed r << 16 | g << 8 | b), unpacked to `o[0..2]`.
__device__ __forceinline__ void slot_pixel(int c, uint8_t* o) {
  o[0] = static_cast<uint8_t>(c >> 16);
  o[1] = static_cast<uint8_t>((c >> 8) & 255);
  o[2] = static_cast<uint8_t>(c & 255);
}

// The columns of one output's aa x aa box block, from canvas column `bx`,
// as 32-bit words of the row: the first word's index, the number of words
// and the byte masks of the first and the last (both, for one word).
struct BoxCols {
  int word, nw;
  unsigned first, last;
};

__device__ __forceinline__ BoxCols box_cols(int bx, int aa) {
  const int off = bx & 3;
  BoxCols b;
  b.word = bx >> 2;
  b.nw = (off + aa + 3) >> 2;
  b.first = ~low_bytes(off);
  b.last = low_bytes(off + aa - 4 * (b.nw - 1));
  return b;
}

__device__ __forceinline__ unsigned box_mask(const BoxCols& b, int q) {
  return (q == 0 ? b.first : kFull) & (q == b.nw - 1 ? b.last : kFull);
}

// The box filter of up to 32 output pixels, one a lane (those `active`):
// each channel's integer sum over the lane's aa x aa canvas block (rows
// from `by`, columns from `bx` of `canvas`, rows of `pitch` bytes, a
// multiple of 4), divided once, correctly rounded, by aa * aa and rounded
// half to even, as the plain version does; written to `o[0..2]`. Every warp
// lane calls this. The block is read as words: each is compared with the
// block's first slot byte replicated, masked to the block's columns. A
// block of one slot throughout (94% of them at 64x64/AA=5, 99% at
// 256x256/AA=10 on the paths' scenes) is that slot's colour: its sums are
// aa * aa times the colour, which the division returns exactly. The warp
// sums the other blocks together, one at a time: lanes take the block's
// words (up to four a row, eight rows a pass), turn slot bytes into channel
// bytes (`resolve`), mask them to the block's columns and add four at a
// time with __dp4a; a warp reduction gives each channel's sum.
template <int kRoute>
__device__ __forceinline__ void box_words(const uint8_t* canvas, int pitch,
                                          int aa, int by, int bx,
                                          bool active, const int* ctab,
                                          const ChanRegs& regs,
                                          const uint8_t* chan, int kc,
                                          uint8_t* o, int lane) {
  const unsigned* words = reinterpret_cast<const unsigned*>(canvas);
  const int pw = pitch >> 2;
  const BoxCols cols = box_cols(bx, aa);
  const unsigned slot = active ? canvas[size_t(by) * pitch + bx] : 0u;
  const unsigned rep = slot * 0x01010101u;
  unsigned diff = 0u;
  if (active) {
    const unsigned* p = words + size_t(by) * pw + cols.word;
    if (cols.nw == 2) {  // every block at anti_aliasing 5
      for (int dy = 0; dy < aa; ++dy, p += pw)
        diff |= ((p[0] ^ rep) & cols.first) | ((p[1] ^ rep) & cols.last);
    } else if (cols.nw == 3) {  // every block at anti_aliasing 10
      for (int dy = 0; dy < aa; ++dy, p += pw)
        diff |= ((p[0] ^ rep) & cols.first) | (p[1] ^ rep)
                | ((p[2] ^ rep) & cols.last);
    } else {
      for (int dy = 0; dy < aa; ++dy, p += pw)
        for (int q = 0; q < cols.nw; ++q)
          diff |= (p[q] ^ rep) & box_mask(cols, q);
    }
  }
  unsigned sum[3] = {0u, 0u, 0u};
  for (unsigned rest = __ballot_sync(kFull, diff != 0u); rest;
       rest &= rest - 1u) {
    const int src = __ffs(rest) - 1;
    const int sby = __shfl_sync(kFull, by, src);
    const BoxCols sc = box_cols(__shfl_sync(kFull, bx, src), aa);
    // Lane (dy, q) = (lane / 4, lane % 4) to start: 8 rows of up to 4 words
    // a pass.
    unsigned part[3] = {0u, 0u, 0u};
    for (int dy = lane >> 2; dy < aa; dy += 8) {
      const unsigned* p = words + size_t(sby + dy) * pw + sc.word;
      for (int q = lane & 3; q < sc.nw; q += 4) {
        const unsigned wv = p[q];
        const unsigned m = box_mask(sc, q);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          part[ch] = __dp4a(resolve<kRoute>(wv, ch, regs, chan, kc) & m,
                            0x01010101u, part[ch]);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const unsigned total = __reduce_add_sync(kFull, part[ch]);
      if (lane == src) sum[ch] = total;
    }
  }
  if (!active) return;
  if (diff == 0u) {
    slot_pixel(ctab[slot], o);
    return;
  }
  const float n = static_cast<float>(aa * aa);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    o[ch] = static_cast<uint8_t>(
        rintf(__fdiv_rn(static_cast<float>(sum[ch]), n)));
}

// Output pixel x of an image row whose canvas rows start at row `by` of
// `canvas`, written to `o`: background where its columns meet no sprite of
// `on` (sprites_on_rows of those rows), else its box filter (DS_BOX) or, at
// anti_aliasing=1, its slot's colour. Every warp lane calls this, those
// with x >= w too: box_words holds warp collectives.
template <int kRoute>
__device__ __forceinline__ void output_pixel(const uint8_t* canvas, int cp,
                                             int aa, int ds, int by, int x,
                                             int w, const float* tab, int NT,
                                             unsigned on, const int* ctab,
                                             const ChanRegs& regs,
                                             const uint8_t* chan, int kc,
                                             uint8_t* o, int lane) {
  const bool met =
      x < w && columns_meet(tab, NT, on, x * aa, x * aa + aa - 1);
  if (ds == DS_BOX)
    box_words<kRoute>(canvas, cp, aa, by, x * aa, met, ctab, regs, chan, kc,
                      o, lane);
  else if (met)
    slot_pixel(ctab[canvas[size_t(by) * cp + x]], o);
  if (x < w && !met) slot_pixel(ctab[0], o);
}

}  // namespace sw
