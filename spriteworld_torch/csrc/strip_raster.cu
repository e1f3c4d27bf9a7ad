// Row-strip rasterizer for Hopper (sm_90a): one thread block renders one
// strip of canvas rows of one scene, for canvases too large for the scene
// kernel's shared memory (scene_raster.cu).
//
// Replaces the TPU kernel `_fill_kernel` of
// spriteworld_tpu/ops/rasterize_pallas.py in its row-strip mode (its
// pallas_call at the end of render_rgb_batch), and the vertical Lanczos pass
// and flip that XLA runs after it. It computes the same function as the
// scene kernel, in all its modes, from the same per-sprite tables
// (spriteworld_torch/ops/rasterize_cuda.py `prepare`): Pillow's exact
// scanline fill or the centroid fill of every sprite polygon painted back to
// front on the anti_aliasing-supersampled canvas, Pillow's Lanczos
// downsample, the box filter or none (anti_aliasing=1), and the vertical
// flip to math coordinates. Only the tiling differs.
//
// Two kernels:
// * strip_raster_kernel: per (scene, strip), cull sprites by row bounds,
//   fill them with `sw::fill_sprite` or `sw::fill_sprite_centroid`
//   (raster_fill.cuh, shared with the scene kernel) into a u8 top-slot
//   canvas of strip_rows x wc bytes in shared memory, then run the
//   horizontal Lanczos pass in Pillow's int32 fixed point with its
//   intermediate u8 rounding, writing u8[B][hc][w][3] in Pillow's row
//   order. At anti_aliasing=1 it writes the strip straight out as the
//   flipped image instead. With the box filter the strips hold a multiple
//   of aa rows, so every output pixel's aa x aa block lies in one strip: the
//   kernel writes its rows of the flipped image directly (`sw::box_pixel`),
//   and no second kernel runs.
// * strip_vpass_kernel: the vertical Lanczos pass over that buffer, one
//   thread per output pixel, in the same fixed point, writing u8[B][h][w][3]
//   already flipped. Its support (3 * anti_aliasing canvas rows each side)
//   crosses strip boundaries, hence the second kernel.
//
// What bounds it. At 256x256, anti_aliasing=10 a scene's canvas is
// 2560x2560. The h-pass reads ~61 taps for each of 2560 x 256 outputs and 3
// channels (~120 M integer multiply-adds a scene) and outweighs the fill
// (~4 sprites x ~0.2 M pixels of bounds x a compare and an add per edge).
// The h-pass buffer is 1.9 MB a scene, written once and read by the v-pass.
// Both kernels are bound by operations. With the box filter the strip
// kernel alone runs: aa * aa adds per output channel (~20 M a scene at
// anti_aliasing=10) and the fill, still operations against ~0.2 MB of
// output a scene.
//
// Design.
// * Shared memory holds only the strip's canvas (one byte per pixel: 0 =
//   background, k + 1 = sprite k), the K + 1 colour table and the per-warp
//   crossing scratch. The sprite tables are read from device memory through
//   the L1 cache, and the h-pass taps through the read-only cache, stored
//   transposed (tap t of output ox at t * w + ox) so a warp's 32 outputs
//   read 32 neighbouring words. So a block's shared memory does not grow
//   with K or with the tap count, and strip_rows (a launch argument) sets it.
// * Canvas row r belongs to warp r % 8 for every sprite (fill_sprite), so
//   the painter's order needs no block barrier between sprites.
// * Integer sums are exact in any order, so both passes equal Pillow's and
//   the plain version's on every value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fill.cuh"

namespace {

using namespace sw;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVpassThreads = 256;

struct Layout {
  // Word offsets of the colour table and crossing scratch, byte offset of
  // the canvas.
  int ctab, xi, wgt;
  size_t canvas, bytes;
};

__host__ __device__ inline Layout layout(int K, int strip_rows, int wc) {
  Layout L;
  L.ctab = 0;
  L.xi = L.ctab + K + 1;
  L.wgt = L.xi + kWarps * 32;
  L.canvas = round16(size_t(L.wgt + kWarps * 32) * 4);
  L.bytes = L.canvas + round16(size_t(strip_rows) * wc);
  return L;
}

__global__ void __launch_bounds__(kThreads)
strip_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                    int hc, int wc, int h, int w, int centroid, int ds,
                    int strip_rows, int num_strips,
                    const int* __restrict__ hx0,
                    const int* __restrict__ hqt, int ht, int bg_packed,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(K, strip_rows, wc);
  int* s_ctab = reinterpret_cast<int*>(smem) + L.ctab;
  float* s_xi = reinterpret_cast<float*>(smem) + L.xi;
  int* s_wgt = reinterpret_cast<int*>(smem) + L.wgt;
  uint8_t* canvas = smem + L.canvas;

  const int tid = threadIdx.x;
  const int scene = blockIdx.x / num_strips;
  const int row_begin = (blockIdx.x - scene * num_strips) * strip_rows;
  const int rows = min(strip_rows, hc - row_begin);
  const float* scene_tab = tab + size_t(scene) * K * NT;
  for (int i = tid; i <= K; i += kThreads)
    s_ctab[i] = i == 0 ? bg_packed
                       : static_cast<int>(scene_tab[(i - 1) * NT + T_COLOR]);
  uint32_t* canvas32 = reinterpret_cast<uint32_t*>(canvas);
  for (int i = tid; i < (rows * wc + 3) / 4; i += kThreads) canvas32[i] = 0u;
  __syncthreads();

  // ---- fill of the sprites that reach this strip ------------------------ //
  const int warp = tid >> 5, lane = tid & 31;
  float* wx = s_xi + warp * 32;
  int* ww = s_wgt + warp * 32;
  for (int k = 0; k < K; ++k) {
    const float* st = scene_tab + k * NT;
    if (static_cast<int>(st[T_COUNT]) <= 0) continue;
    const int r0 = max(static_cast<int>(st[T_ROW0]), row_begin);
    const int r1 = min(static_cast<int>(st[T_ROW1]), row_begin + rows - 1);
    if (r0 > r1) continue;  // the sprite misses this strip
    const uint8_t value = static_cast<uint8_t>(k + 1);
    const int c0 = max(static_cast<int>(st[T_COL0]), 0);
    const int c1 = min(static_cast<int>(st[T_COL1]), wc - 1);
    if (centroid)
      fill_sprite_centroid(st, V, value, r0, r1, c0, c1, row_begin, canvas,
                           wc, wx, warp, kWarps, lane);
    else
      fill_sprite(st, V, value, r0, r1, c0, c1, row_begin, canvas, wc, wx,
                  ww, warp, kWarps, lane);
  }
  __syncthreads();

  if (ds != DS_LANCZOS) {  // identity or box: this strip's image rows
    const int aa = hc / h;  // 1 for the identity
    const int out_begin = row_begin / aa;
    uint8_t* img = out + size_t(scene) * h * w * 3;
    for (int i = tid; i < (rows / aa) * w; i += kThreads) {
      const int y = i / w, x = i - y * w;
      uint8_t* o = img + (size_t(h - 1 - out_begin - y) * w + x) * 3;
      if (ds == DS_BOX)
        box_pixel(canvas + (y * aa) * wc + x * aa, wc, aa, s_ctab, o);
      else
        slot_pixel(s_ctab[canvas[y * wc + x]], o);
    }
    return;
  }
  // ---- horizontal Lanczos pass: canvas row y, output column ox ---------- //
  uint8_t* hp = out + (size_t(scene) * hc + row_begin) * w * 3;
  for (int i = tid; i < rows * w; i += kThreads) {
    const int y = i / w, ox = i - y * w;
    const uint8_t* src = canvas + y * wc + __ldg(hx0 + ox);
    int ar = 1 << 21, ag = 1 << 21, ab = 1 << 21;
    for (int t = 0; t < ht; ++t) {
      const int c = s_ctab[src[t]];
      const int qt = __ldg(hqt + t * w + ox);
      ar += qt * (c >> 16);
      ag += qt * ((c >> 8) & 255);
      ab += qt * (c & 255);
    }
    uint8_t* o = hp + size_t(i) * 3;
    o[0] = clip8(ar);
    o[1] = clip8(ag);
    o[2] = clip8(ab);
  }
}

__global__ void __launch_bounds__(kVpassThreads)
strip_vpass_kernel(const uint8_t* __restrict__ hp, long long total, int hc,
                   int w, int h, const int* __restrict__ vy0,
                   const int* __restrict__ vq, int vt,
                   uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const int ox = static_cast<int>(i % w);
  const long long r = i / w;
  const int oy = static_cast<int>(r % h);
  const long long scene = r / h;
  const uint8_t* src = hp + ((scene * hc + __ldg(vy0 + oy)) * w + ox) * 3;
  const int* q = vq + oy * vt;
  int ar = 1 << 21, ag = 1 << 21, ab = 1 << 21;
  for (int t = 0; t < vt; ++t) {
    const uint8_t* p = src + size_t(t) * w * 3;
    const int qt = __ldg(q + t);
    ar += qt * p[0];
    ag += qt * p[1];
    ab += qt * p[2];
  }
  uint8_t* o = out + ((scene * h + (h - 1 - oy)) * w + ox) * 3;
  o[0] = clip8(ar);
  o[1] = clip8(ag);
  o[2] = clip8(ab);
}

}  // namespace

// Shared memory a strip_raster block needs; the renderer's dispatch checks
// its Python mirror (rasterize_cuda.strip_smem_bytes) against this.
extern "C" long long strip_raster_smem_bytes(int K, int strip_rows, int wc) {
  return static_cast<long long>(layout(K, strip_rows, wc).bytes);
}

// Fill and h-pass (ds == DS_LANCZOS) or the flipped image (DS_IDENTITY, or
// DS_BOX with strip_rows a multiple of anti_aliasing) of B scenes in strips
// of `strip_rows` canvas rows; `centroid` selects the fill. Outside
// DS_LANCZOS ht is 0 and the tap pointers may be null. Launches on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int strip_raster_launch(const float* tab, int B, int K, int V,
                                   int NT, int hc, int wc, int h, int w,
                                   int centroid, int ds, int strip_rows,
                                   const int* hx0,
                                   const int* hqt, int ht, int bg_packed,
                                   uint8_t* out, void* stream) {
  const Layout L = layout(K, strip_rows, wc);
  cudaError_t err = cudaFuncSetAttribute(
      strip_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_strips = (hc + strip_rows - 1) / strip_rows;
  strip_raster_kernel<<<B * num_strips, kThreads, L.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      tab, K, V, NT, hc, wc, h, w, centroid, ds, strip_rows, num_strips, hx0,
      hqt, ht, bg_packed, out);
  return static_cast<int>(cudaGetLastError());
}

// Vertical pass of B h-pass buffers u8[B][hc][w][3] into flipped images
// u8[B][h][w][3]. Launches on `stream`; returns the CUDA error code.
extern "C" int strip_vpass_launch(const uint8_t* hp, int B, int hc, int w,
                                  int h, const int* vy0, const int* vq,
                                  int vt, uint8_t* out, void* stream) {
  const long long total = static_cast<long long>(B) * h * w;
  const long long blocks = (total + kVpassThreads - 1) / kVpassThreads;
  strip_vpass_kernel<<<static_cast<unsigned>(blocks), kVpassThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      hp, total, hc, w, h, vy0, vq, vt, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
