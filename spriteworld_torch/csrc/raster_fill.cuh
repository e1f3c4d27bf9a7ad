// The two polygon fills of one sprite, shared by the scene kernel
// (scene_raster.cu), the row-strip kernel (strip_raster.cu) and the small
// anti_aliasing=1 kernel (packed_raster.cu), and the box filter those with
// a downsample share.
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

// Crossings a row keeps in registers in `fill_sprite`; rows with more use
// the warp's shared scratch.
constexpr int kRegCrossings = 4;

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
    const float xi = __fadd_rn(x0, __fmul_rn(__fsub_rn(rf, y0), m));
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

// The box filter of one output pixel: the integer sum of each channel over
// the aa x aa canvas block whose top-left slot is `block` (slots through the
// colour table `ctab`), divided once, correctly rounded, by aa * aa and
// rounded half to even; written to `o[0..2]`.
__device__ __forceinline__ void box_pixel(const uint8_t* block, int wc,
                                          int aa, const int* ctab,
                                          uint8_t* o) {
  int sr = 0, sg = 0, sb = 0;
  for (int dy = 0; dy < aa; ++dy) {
    const uint8_t* row = block + dy * wc;
    for (int dx = 0; dx < aa; ++dx) {
      const int c = ctab[row[dx]];
      sr += c >> 16;
      sg += (c >> 8) & 255;
      sb += c & 255;
    }
  }
  const float n = static_cast<float>(aa * aa);
  o[0] = static_cast<uint8_t>(rintf(__fdiv_rn(static_cast<float>(sr), n)));
  o[1] = static_cast<uint8_t>(rintf(__fdiv_rn(static_cast<float>(sg), n)));
  o[2] = static_cast<uint8_t>(rintf(__fdiv_rn(static_cast<float>(sb), n)));
}

// One slot's colour, unpacked to `o[0..2]` (the identity downsample).
__device__ __forceinline__ void slot_pixel(int c, uint8_t* o) {
  o[0] = static_cast<uint8_t>(c >> 16);
  o[1] = static_cast<uint8_t>((c >> 8) & 255);
  o[2] = static_cast<uint8_t>(c & 255);
}

}  // namespace sw
