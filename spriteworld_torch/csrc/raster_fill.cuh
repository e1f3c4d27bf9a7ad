// Pillow's exact polygon fill of one sprite, shared by the scene kernel
// (scene_raster.cu) and the row-strip kernel (strip_raster.cu).
//
// Inputs are one sprite's row of the packed table of
// spriteworld_torch/ops/rasterize_cuda.py (`prepare`): 8 scalars, 5 edge
// fields of V values, then 2V features (row, lo, hi).
//
// Canvas row r belongs to warp r % num_warps, and lane e holds edge e. For
// each row the warp computes xi = x0 + (r - y0) * m with __fmul_rn/__fadd_rn
// (two roundings, as Pillow; nvcc would otherwise contract to an FMA), the
// edge's Pillow weight with the bottom-duplicate rule, and by warp
// reductions the row's total weight and its first maximum crossing: the
// odd-total trim drops one instance of it. Each lane then fills columns of
// the sprite's bounds: odd(sum of weights with xi <= c - 0.5) or some weight
// with c - 0.5 < xi < c + 0.5, or a horizontal-edge/wedge feature interval
// on this row. A row is only ever written by its own warp, so the painter's
// order needs no block barrier between sprites.

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

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Pillow's clip8 of an int32 fixed-point accumulator (taps q / 2^22).
__device__ __forceinline__ uint8_t clip8(int acc) {
  const int v = acc >> 22;  // arithmetic shift: floor division by 2^22
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
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
    __syncwarp();
    wx[lane] = xi;
    ww[lane] = wgt;
    __syncwarp();

    uint8_t* crow = canvas + size_t(r - row_base) * wc;
    for (int c = c0 + lane; c <= c1; c += 32) {
      const float cf = static_cast<float>(c);
      const float cm = cf - 0.5f, cp = cf + 0.5f;
      int le = 0, win = 0;
      for (int e = 0; e < count; ++e) {
        const float x = wx[e];
        if (x <= cm) le += ww[e];
        else if (x < cp) win += ww[e];
      }
      bool fill = (le & 1) || win > 0;
      for (int j = 0; j < nf && !fill; ++j) {
        const float* f = feat + 3 * j;
        fill = f[0] == rf && f[1] <= cf && cf <= f[2];
      }
      if (fill) crow[c] = value;
    }
  }
}

}  // namespace sw
