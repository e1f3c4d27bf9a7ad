// Scene rasterizer for Hopper (sm_90a): one thread block renders one scene.
//
// Replaces the TPU kernel `_fill_kernel_scene` of
// spriteworld_tpu/ops/rasterize_pallas.py (its pallas_call at the scene
// branch of render_rgb_batch), in all its modes. It paints every sprite
// polygon back to front on the anti_aliasing-supersampled canvas with
// Pillow's exact scanline fill or the centroid fill (the even-odd test at
// pixel centres), downsamples with Pillow's Lanczos filter, the box filter
// or none (anti_aliasing=1), and flips to math coordinates. Inputs are the
// per-sprite tables of spriteworld_torch/ops/rasterize_cuda.py (`prepare`);
// the plain torch version there computes the same values.
//
// What bounds it. The output is 64*64*3 bytes a scene and the tables ~8 KB,
// so at 2048 scenes the kernel moves ~40 MB: ~12 us at 3.35 TB/s. The work
// is scalar arithmetic: per filled-region pixel a test of each of the
// sprite's <= 30 scanline crossings (the exact fill) or of the row's ~2
// straddling crossings (the centroid fill), and per output ~31 integer
// multiply-adds per channel and pass (Lanczos) or aa*aa adds (box). The
// kernel is bound by operations.
//
// Design.
// * The TPU kernel keeps an f32 packed-RGB canvas (400 KiB at 320x320) and
//   f32 crossing and weight tables (288 KiB each) in VMEM. None fits the
//   227 KiB of shared memory a block may use. Here the canvas holds the
//   index of the topmost sprite of each pixel, one byte (0 = background,
//   k + 1 = sprite k): 100 KiB at 320x320. Later sprites overwrite earlier
//   ones (painter's order); colours stay in a K + 1 entry table.
// * Crossings are recomputed per (row, edge) instead of stored, one warp per
//   canvas row and one lane per edge: the fills are `sw::fill_sprite` and
//   `sw::fill_sprite_centroid` of raster_fill.cuh, which the row-strip and
//   anti_aliasing=1 kernels share. The centroid crossing is computed with
//   ops/geometry.py's roundings, not the TPU kernel's x0 + (row - y0) * m,
//   so the kernel equals the port's CPU centroid fill bit for bit.
// * The Lanczos filter runs in Pillow's own int32 fixed point with the
//   integer taps q (tap = q / 2^22): acc = 2^21 + sum(q * p), out =
//   clip(acc >> 22, 0, 255). Integer sums are exact in any order, so the
//   result equals Pillow's and the plain version's on every value. The
//   h-pass reads the index canvas through the colour table into a
//   u8[hc][w][3] buffer (60 KiB at 320x64); the v-pass writes the output
//   already flipped.
// * The box filter (`sw::box_pixel`) sums each channel over the aa x aa
//   block in integers and divides once, so it needs neither tap tables nor
//   the h-pass buffer: its layout is the identity's, and 64x64 at
//   anti_aliasing=6 fits a block in box mode where it does not with Lanczos.
//   The TPU kernel multiplied by 1/aa matrices on the MXU instead.
// * Shared memory at 64x64, anti_aliasing=5: ~190 KiB with Lanczos, ~110
//   KiB with the box filter (opted in with cudaFuncSetAttribute), so one
//   block per SM. A canvas whose layout does not fit one block's shared
//   memory goes to the row-strip kernel instead.
// * Left out: the TPU kernel's single-interval fast path for convex sprites
//   (`_scene_fastok`), a speed trick with the same output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fill.cuh"

namespace {

using namespace sw;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Layout {
  // Word offsets (4 bytes) of the small tables, byte offsets of the u8 ones.
  int tab, ctab, xi, wgt, hx0, hq, vy0, vq;
  size_t canvas, hpass, bytes;
};

__host__ __device__ inline Layout layout(int K, int NT, int hc, int wc, int h,
                                         int w, int ht, int vt) {
  Layout L;
  L.tab = 0;
  L.ctab = L.tab + K * NT;
  L.xi = L.ctab + K + 1;
  L.wgt = L.xi + kWarps * 32;
  L.hx0 = L.wgt + kWarps * 32;
  L.hq = L.hx0 + (ht ? w : 0);
  L.vy0 = L.hq + w * ht;
  L.vq = L.vy0 + (vt ? h : 0);
  L.canvas = round16(size_t(L.vq + h * vt) * 4);
  L.hpass = L.canvas + round16(size_t(hc) * wc);
  L.bytes = L.hpass + (ht ? round16(size_t(hc) * w * 3) : 0);
  return L;
}

__global__ void __launch_bounds__(kThreads)
scene_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                    int hc, int wc, int h, int w, int centroid, int ds,
                    const int* __restrict__ hx0, const int* __restrict__ hq,
                    int ht, const int* __restrict__ vy0,
                    const int* __restrict__ vq, int vt, int bg_packed,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(K, NT, hc, wc, h, w, ht, vt);
  float* s_tab = reinterpret_cast<float*>(smem) + L.tab;
  int* s_ctab = reinterpret_cast<int*>(smem) + L.ctab;
  float* s_xi = reinterpret_cast<float*>(smem) + L.xi;
  int* s_wgt = reinterpret_cast<int*>(smem) + L.wgt;
  int* s_hx0 = reinterpret_cast<int*>(smem) + L.hx0;
  int* s_hq = reinterpret_cast<int*>(smem) + L.hq;
  int* s_vy0 = reinterpret_cast<int*>(smem) + L.vy0;
  int* s_vq = reinterpret_cast<int*>(smem) + L.vq;
  uint8_t* canvas = smem + L.canvas;
  uint8_t* hpass = smem + L.hpass;

  const int tid = threadIdx.x;
  const float* scene = tab + size_t(blockIdx.x) * K * NT;
  for (int i = tid; i < K * NT; i += kThreads) s_tab[i] = scene[i];
  for (int i = tid; i <= K; i += kThreads)
    s_ctab[i] = i == 0 ? bg_packed : static_cast<int>(scene[(i - 1) * NT + T_COLOR]);
  for (int i = tid; i < w * ht; i += kThreads) s_hq[i] = hq[i];
  for (int i = tid; i < h * vt; i += kThreads) s_vq[i] = vq[i];
  if (ht)
    for (int i = tid; i < w; i += kThreads) s_hx0[i] = hx0[i];
  if (vt)
    for (int i = tid; i < h; i += kThreads) s_vy0[i] = vy0[i];
  uint32_t* canvas32 = reinterpret_cast<uint32_t*>(canvas);
  for (int i = tid; i < (hc * wc + 3) / 4; i += kThreads) canvas32[i] = 0u;
  __syncthreads();

  // ---- fill, sprite by sprite, one warp per canvas row ----------------- //
  const int warp = tid >> 5, lane = tid & 31;
  float* wx = s_xi + warp * 32;
  int* ww = s_wgt + warp * 32;
  for (int k = 0; k < K; ++k) {
    const float* st = s_tab + k * NT;
    if (static_cast<int>(st[T_COUNT]) <= 0) continue;
    const uint8_t value = static_cast<uint8_t>(k + 1);
    const int r0 = max(static_cast<int>(st[T_ROW0]), 0);
    const int r1 = min(static_cast<int>(st[T_ROW1]), hc - 1);
    const int c0 = max(static_cast<int>(st[T_COL0]), 0);
    const int c1 = min(static_cast<int>(st[T_COL1]), wc - 1);
    if (centroid)
      fill_sprite_centroid(st, V, value, r0, r1, c0, c1, 0, canvas, wc, wx,
                           warp, kWarps, lane);
    else
      fill_sprite(st, V, value, r0, r1, c0, c1, 0, canvas, wc, wx, ww, warp,
                  kWarps, lane);
  }
  __syncthreads();

  // ---- downsample and flip --------------------------------------------- //
  uint8_t* img = out + size_t(blockIdx.x) * h * w * 3;
  if (ds != DS_LANCZOS) {  // identity (anti_aliasing=1) or box
    const int aa = hc / h;
    for (int i = tid; i < h * w; i += kThreads) {
      const int y = i / w, x = i - y * w;
      uint8_t* o = img + ((h - 1 - y) * w + x) * 3;
      if (ds == DS_BOX)
        box_pixel(canvas + (y * aa) * wc + x * aa, wc, aa, s_ctab, o);
      else
        slot_pixel(s_ctab[canvas[y * wc + x]], o);
    }
    return;
  }
  // Horizontal pass: canvas row y, output column ox.
  for (int i = tid; i < hc * w; i += kThreads) {
    const int y = i / w, ox = i - y * w;
    const uint8_t* src = canvas + y * wc + s_hx0[ox];
    const int* q = s_hq + ox * ht;
    int ar = 1 << 21, ag = 1 << 21, ab = 1 << 21;
    for (int t = 0; t < ht; ++t) {
      const int c = s_ctab[src[t]];
      const int qt = q[t];
      ar += qt * (c >> 16);
      ag += qt * ((c >> 8) & 255);
      ab += qt * (c & 255);
    }
    uint8_t* o = hpass + i * 3;
    o[0] = clip8(ar);
    o[1] = clip8(ag);
    o[2] = clip8(ab);
  }
  __syncthreads();
  // Vertical pass: output row oy, written flipped.
  for (int i = tid; i < h * w; i += kThreads) {
    const int oy = i / w, ox = i - oy * w;
    const uint8_t* src = hpass + (s_vy0[oy] * w + ox) * 3;
    const int* q = s_vq + oy * vt;
    int ar = 1 << 21, ag = 1 << 21, ab = 1 << 21;
    for (int t = 0; t < vt; ++t) {
      const uint8_t* p = src + t * w * 3;
      const int qt = q[t];
      ar += qt * p[0];
      ag += qt * p[1];
      ab += qt * p[2];
    }
    uint8_t* o = img + ((h - 1 - oy) * w + ox) * 3;
    o[0] = clip8(ar);
    o[1] = clip8(ag);
    o[2] = clip8(ab);
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
// `centroid` selects the fill (tables of prepare(pil_exact=False)), `ds` the
// downsample (DS_IDENTITY, DS_LANCZOS or DS_BOX). Outside DS_LANCZOS, ht and
// vt are 0 and the tap pointers may be null.
extern "C" int scene_raster_launch(const float* tab, int B, int K, int V,
                                   int NT, int hc, int wc, int h, int w,
                                   int centroid, int ds, const int* hx0, const int* hq, int ht,
                                   const int* vy0, const int* vq, int vt,
                                   int bg_packed, uint8_t* out, void* stream) {
  const Layout L = layout(K, NT, hc, wc, h, w, ht, vt);
  cudaError_t err = cudaFuncSetAttribute(
      scene_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  scene_raster_kernel<<<B, kThreads, L.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      tab, K, V, NT, hc, wc, h, w, centroid, ds, hx0, hq, ht, vy0, vq, vt,
      bg_packed, out);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory the kernel needs for these sizes (ht = vt = 0 for
// the identity and box modes); the renderer's dispatch compares its Python
// mirror (rasterize_cuda.scene_smem_bytes) with the card's per-block limit
// before launching.
extern "C" long long scene_raster_smem_bytes(int K, int NT, int hc, int wc,
                                             int h, int w, int ht, int vt) {
  return static_cast<long long>(layout(K, NT, hc, wc, h, w, ht, vt).bytes);
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
