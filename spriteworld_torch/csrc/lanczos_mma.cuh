// Pillow's two Lanczos passes on the int8 tensor cores, exactly, shared by
// the scene kernel (scene_raster.cu) and the row-strip kernels
// (strip_raster.cu).
//
// Both passes are banded integer matrix products: out = clip8((2^21 +
// sum q * p) >> 22), with u8 pixels p and Pillow's 22-bit taps q. Each tap
// is split into three limbs, q = hi * 2^16 + mid * 2^8 + lo, with lo and mid
// in [0, 255] (u8) and hi = q >> 16 in [-128, 127] (s8). One
// mma.sync.m16n8k32 per limb gives three int32 partial sums, each exact;
// 2^21 + S_lo + (S_mid << 8) + (S_hi << 16) in wrapping uint32 arithmetic
// is then the exact int32 sum, because the true sum fits int32 (the host
// checks it). So the result equals Pillow's on every value.
//
// Operands. A is always the taps: 16 outputs (M) by the 32-input K step,
// in fragment order from the host (spriteworld_torch/ops/rasterize_cuda.py
// `lanczos_tiles`): for m-tile m, K step s and limb l, lane L holds the int4
// at frags[((m * ks + s) * 3 + l) * 32 + L]. Each m-tile reads the inputs
// [kstart[m], kstart[m] + 32 * ks), kstart a multiple of 16, padded with
// zero taps. B is the image: 8 columns (N) of 32 inputs, each a pair of
// aligned 32-bit words of 4 consecutive inputs.
// * h-pass: B column n is canvas row y0 + n; its inputs are the slot bytes
//   of that row, resolved to one colour channel (`resolve`). The result
//   C[x][y] is stored channel-planar and transposed, hpT[ch][x][y], so that
//   the v-pass reads K-contiguous words.
// * v-pass: B column n is image column x0 + n; its inputs are hpT[ch][x][y]
//   for consecutive y. The result goes to the flipped u8[h][w][3] image.
//
// Slot resolution. The canvas holds slot bytes (0 = background, k + 1 =
// sprite k), which `resolve` (raster_fill.cuh) turns into one colour
// channel four at a time: with K + 1 <= 8 slots by one byte permute
// (kRoute8), with K + 1 <= 16 by two and a byte blend (kRoute16), above that
// by one shared-memory load per byte (kRouteTable). The scene kernel picks
// by K (`route_of`); the strip kernel, held to 80 registers, takes the table
// route for every K, which ran faster there than the register routes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fill.cuh"

namespace sw {

__device__ __forceinline__ int route_of(int K) {
  return K + 1 <= 8 ? kRoute8 : (K + 1 <= 16 ? kRoute16 : kRouteTable);
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const int4& a,
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int4& a,
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The three limb products of one K step into acc[limb].
__device__ __forceinline__ void mma_limbs(int (&acc)[3][4], const int4& lo,
                                          const int4& mid, const int4& hi,
                                          unsigned b0, unsigned b1) {
  mma_u8(acc[0], lo, b0, b1);
  mma_u8(acc[1], mid, b0, b1);
  mma_s8(acc[2], hi, b0, b1);
}

// clip8 of the limb partial sums of one output.
__device__ __forceinline__ uint8_t combine(const int (&acc)[3][4], int i) {
  const uint32_t s = (1u << 21) + static_cast<uint32_t>(acc[0][i])
                     + (static_cast<uint32_t>(acc[1][i]) << 8)
                     + (static_cast<uint32_t>(acc[2][i]) << 16);
  return clip8(static_cast<int>(s));
}

// The taps of one pass, from the host.
struct Taps {
  const int4* frags;   // [mt][ks][3 limbs][32 lanes]
  const int* kstart;   // [mt]
  const int* qsum;     // [16 * mt]: each output's sum of taps (h-pass)
  int ks;              // K steps of 32 inputs
};

// h-pass of one unit: outputs x0 = 16 * m .. + 15 (A = m-tile m's taps)
// of canvas rows row0 .. row0 + 7 (rows of `canvas`, `pitch` bytes each),
// written to hpT[ch][x][yout + n] (planes of `plane` bytes, rows of `hp`
// bytes) for the rows yout + n < ylimit. A window of one slot throughout
// (background, or inside a sprite: about half the units at 64x64,
// anti_aliasing=5 and nine in ten at 256x256, anti_aliasing=10 on the
// paths' scenes) needs no product: its sum is the slot's colour times the
// output's tap sum, the same integer.
template <int kRoute>
__device__ __forceinline__ void hpass_unit(
    const uint8_t* canvas, int pitch, int row0, const Taps& taps, int m,
    const ChanRegs& regs, const uint8_t* chan, int kc, uint8_t* hpT,
    size_t plane, int hp, int yout, int ylimit, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int acc[3][3][4] = {};
  const uint8_t* row = canvas + size_t(row0 + g) * pitch + taps.kstart[m]
                       + 4 * t;
  const unsigned first = *reinterpret_cast<const unsigned*>(
      canvas + size_t(row0) * pitch + taps.kstart[m]);
  const unsigned rep = (first & 0xffu) * 0x01010101u;
  bool same = true;
  for (int s = 0; s < taps.ks; ++s)
    same &= (*reinterpret_cast<const unsigned*>(row + 32 * s) == rep)
            & (*reinterpret_cast<const unsigned*>(row + 32 * s + 16) == rep);
  const int x = 16 * m + g;
  if (__all_sync(kFull, same)) {
    const int q0 = __ldg(taps.qsum + x), q1 = __ldg(taps.qsum + x + 8);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int c = chan[ch * kc + (first & 0xffu)];
      acc[ch][0][0] = acc[ch][0][1] = c * q0;
      acc[ch][0][2] = acc[ch][0][3] = c * q1;
    }
  } else {
    const int4* fr = taps.frags + size_t(m) * taps.ks * 96 + lane;
    for (int s = 0; s < taps.ks; ++s) {
      const int4 lo = __ldg(fr + s * 96);
      const int4 mid = __ldg(fr + s * 96 + 32);
      const int4 hi = __ldg(fr + s * 96 + 64);
      const unsigned w0 = *reinterpret_cast<const unsigned*>(row + 32 * s);
      const unsigned w1 =
          *reinterpret_cast<const unsigned*>(row + 32 * s + 16);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        mma_limbs(acc[ch], lo, mid, hi,
                  resolve<kRoute>(w0, ch, regs, chan, kc),
                  resolve<kRoute>(w1, ch, regs, chan, kc));
    }
  }
  const int y = yout + 2 * t;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // outputs x and x + 8
      uint8_t* o = hpT + ch * plane + size_t(x + 8 * half) * hp + y;
      const uint8_t v0 = combine(acc[ch], 2 * half);
      const uint8_t v1 = combine(acc[ch], 2 * half + 1);
      if (y + 1 < ylimit && !(y & 1)) {
        *reinterpret_cast<uint16_t*>(o) =
            static_cast<uint16_t>(v0 | (v1 << 8));
      } else {  // a strip of odd height, or its last row
        if (y < ylimit) o[0] = v0;
        if (y + 1 < ylimit) o[1] = v1;
      }
    }
  }
}

// v-pass of one unit: output rows oy = 16 * m .. + 15 (A = m-tile m's taps)
// of image columns x0 .. x0 + 7, read from hpT (as hpass_unit writes it)
// and written flipped to img u8[h][w][3].
__device__ __forceinline__ void vpass_unit(const uint8_t* hpT, size_t plane,
                                           int hp, const Taps& taps, int m,
                                           int x0, int h, int w,
                                           uint8_t* img, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int acc[3][3][4] = {};
  const uint8_t* col = hpT + size_t(x0 + g) * hp + taps.kstart[m] + 4 * t;
  const int4* fr = taps.frags + size_t(m) * taps.ks * 96 + lane;
  for (int s = 0; s < taps.ks; ++s) {
    const int4 lo = __ldg(fr + s * 96);
    const int4 mid = __ldg(fr + s * 96 + 32);
    const int4 hi = __ldg(fr + s * 96 + 64);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const uint8_t* p = col + ch * plane + 32 * s;
      mma_limbs(acc[ch], lo, mid, hi, *reinterpret_cast<const unsigned*>(p),
                *reinterpret_cast<const unsigned*>(p + 16));
    }
  }
  const int x = x0 + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // output rows oy and oy + 8
    const int oy = 16 * m + g + 8 * half;
    if (oy >= h) continue;
    uint8_t* o = img + (size_t(h - 1 - oy) * w + x) * 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)  // columns x and x + 1
      if (x + j < w)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          o[3 * j + ch] = combine(acc[ch], 2 * half + j);
  }
}

}  // namespace sw
