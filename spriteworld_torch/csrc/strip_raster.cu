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
//   canvas of strip_rows rows in shared memory, then run the horizontal
//   Lanczos pass on the int8 tensor cores (lanczos_mma.cuh), exactly, with
//   Pillow's intermediate u8 rounding, into the scene's transposed,
//   channel-planar buffer hpT u8[B][3][wp][hp] (output column x's canvas
//   rows at bytes 0..hc-1 of row x). At anti_aliasing=1 it writes the strip
//   straight out as the flipped image instead. With the box filter the
//   strips hold a multiple of aa rows, so every output pixel's aa x aa block
//   lies in one strip: the kernel writes its rows of the flipped image
//   directly (`sw::box_words`), and no second kernel runs.
// * strip_vpass_kernel: the vertical Lanczos pass over that buffer on the
//   tensor cores, one warp per (scene, 8 output columns), writing
//   u8[B][h][w][3] already flipped. Its support (3 * anti_aliasing canvas
//   rows each side) crosses strip boundaries, hence the second kernel.
//
// What bounds it. At 256x256, anti_aliasing=10 a scene's canvas is
// 2560x2560. The h-pass reads ~61 taps for each of 2560 x 256 outputs and 3
// channels (~120 M multiply-adds a scene): on the int8 tensor cores that is
// less than the fill's work (~4 sprites x ~0.2 M pixels of bounds, each
// tested against the row's ~2 compacted crossings). The h-pass buffer is
// ~2 MB a scene, written once and read by the v-pass, which is bound by
// those bytes. With the box filter the strip kernel alone runs: aa * aa
// adds per output channel (~20 M a scene at anti_aliasing=10) and the
// fill, operations against ~0.2 MB of output a scene; as this kernel does
// it, a compare per 32-bit word of the blocks that meet a sprite's bounds
// (99% of blocks hold one slot at 256x256, anti_aliasing=10), sums for the
// rest, and the fill.
//
// Design.
// * Shared memory holds only the strip's canvas (one byte per pixel: 0 =
//   background, k + 1 = sprite k; with Lanczos rows at the h-pass taps'
//   pitch, rounded up to whole 8-row tiles), the K + 1 colour and channel
//   tables and the per-warp crossing scratch. The sprite tables are read
//   from device memory through the L1 cache, and the taps' mma fragments
//   through the read-only cache, so a block's shared memory does not grow
//   with K or with the tap count, and strip_rows (a launch argument) sets
//   it. The Lanczos instantiation is held to 80 registers, so three blocks
//   of the default 64 KiB canvas share an SM.
// * h-pass units run row tiles fastest, so the block's warps share an
//   m-tile's taps in the L1 cache; the v-pass's warps walk the m-tiles top
//   to bottom, so neighbouring windows meet there too. At anti_aliasing=10
//   most h-pass windows are one slot throughout (background or a sprite's
//   inside) and skip the products: colour times the output's tap sum.
// * Canvas row r belongs to warp r % 8 for every sprite (fill_sprite), so
//   the painter's order needs no block barrier between sprites.
// * The box filter (`sw::box_words`) reads each aa x aa block as 32-bit
//   words: a block of one slot throughout is that slot's colour, and the
//   warp sums the rest together, by words, with byte permutes and __dp4a.
//   A strip no sprite's bounds reach is not zeroed and reads no canvas, nor
//   does an output whose columns meet no sprite's bounds: both are
//   background. That instantiation is held to 64 registers, so four of its
//   53 KB strips share an SM.
// * Integer sums are exact in any order, so both passes and the box filter
//   equal Pillow's and the plain version's on every value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanczos_mma.cuh"
#include "raster_fill.cuh"

namespace {

using namespace sw;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVpassThreads = 256;
constexpr int kVpassWarps = kVpassThreads / 32;

struct Layout {
  // Word offsets of the colour table and crossing scratch, byte offsets of
  // the canvas and the channel tables.
  int ctab, xi, wgt;
  size_t canvas, chan, bytes;
};

// `rows` x `cp` bytes of canvas (with the Lanczos filter round8(strip_rows)
// rows at the h-pass taps' pitch; otherwise strip_rows rows of wc rounded up
// to 16), then the channel tables.
__host__ __device__ inline Layout layout(int K, int rows, int cp) {
  Layout L;
  L.ctab = 0;
  L.xi = L.ctab + K + 1;
  L.wgt = L.xi + kWarps * 32;
  L.canvas = round16(size_t(L.wgt + kWarps * 32) * 4);
  L.chan = L.canvas + round16(size_t(rows) * cp);
  L.bytes = L.chan + round16(size_t(3) * chan_stride(K));
  return L;
}

// Slots resolve through the shared channel table for every K: held to 80
// registers, this kernel ran slower with the register routes' tables.
__device__ void strip_hpass(const uint8_t* canvas, int cp, int rows,
                            int row_begin, const Taps& ht, int mt,
                            const uint8_t* chan, int kc, uint8_t* hpT,
                            size_t plane, int hp, int warp, int lane) {
  const ChanRegs unused{};
  // Row tiles vary fastest, so the block's warps share an m-tile's taps in
  // the L1 cache.
  const int nt = (rows + 7) >> 3;
  for (int u = warp; u < mt * nt; u += kWarps) {
    const int m = u / nt, n = u % nt;
    hpass_unit<kRouteTable>(canvas, cp, 8 * n, ht, m, unused, chan, kc, hpT,
                            plane, hp, row_begin + 8 * n, row_begin + rows,
                            lane);
  }
}

// This strip's output rows, `rows / aa` of them from output row
// `out_begin`, written flipped: a warp takes 32 pixels of a row at a time
// (`output_pixel`; `on`: sprites_on_rows of the strip's rows).
template <int kRoute>
__device__ __forceinline__ void strip_output(const uint8_t* canvas, int cp,
                                             int rows, int aa, int ds,
                                             int h, int w, int out_begin,
                                             const float* tab, int NT,
                                             unsigned on, const int* ctab,
                                             const uint8_t* chan, int kc,
                                             uint8_t* img, int warp,
                                             int lane) {
  ChanRegs regs;
  if (kRoute != kRouteTable) load_chan_regs(regs, chan, kc);
  const int xt = (w + 31) >> 5;
  for (int u = warp; u < (rows / aa) * xt; u += kWarps) {
    const int y = u / xt, x = 32 * (u - y * xt) + lane;
    output_pixel<kRoute>(canvas, cp, aa, ds, y * aa, x, w, tab, NT, on, ctab,
                         regs, chan, kc,
                         img + (size_t(h - 1 - out_begin - y) * w + x) * 3,
                         lane);
  }
}

// kLanczos: the DS_LANCZOS instantiation, held to three blocks an SM (the
// default 64 KiB canvas allows three). The others (identity, box) leave out
// the tensor-core pass and are held to four (64 registers), which the box
// strip's 53 KB of shared memory allows.
template <bool kLanczos>
__global__ void __launch_bounds__(kThreads, kLanczos ? 3 : 4)
strip_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                    int hc, int wc, int h, int w, int centroid, int ds,
                    int strip_rows, int num_strips, int cp, Taps ht, int hp,
                    int bg_packed, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int canvas_rows = kLanczos ? (strip_rows + 7) & ~7 : strip_rows;
  const Layout L = layout(K, canvas_rows, cp);
  int* s_ctab = reinterpret_cast<int*>(smem) + L.ctab;
  float* s_xi = reinterpret_cast<float*>(smem) + L.xi;
  int* s_wgt = reinterpret_cast<int*>(smem) + L.wgt;
  uint8_t* canvas = smem + L.canvas;
  uint8_t* chan = smem + L.chan;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int scene = blockIdx.x / num_strips;
  const int row_begin = (blockIdx.x - scene * num_strips) * strip_rows;
  const int rows = min(strip_rows, hc - row_begin);
  const float* scene_tab = tab + size_t(scene) * K * NT;
  for (int i = tid; i <= K; i += kThreads)
    s_ctab[i] = i == 0 ? bg_packed
                       : static_cast<int>(scene_tab[(i - 1) * NT + T_COLOR]);
  const int kc = chan_stride(K);
  for (int i = tid; i < 3 * kc; i += kThreads) {
    const int ch = i / kc, slot = i - ch * kc;
    const int c = slot == 0 ? bg_packed
                  : slot <= K ? static_cast<int>(
                                    scene_tab[(slot - 1) * NT + T_COLOR])
                              : 0;
    chan[i] = static_cast<uint8_t>(c >> (16 - 8 * ch));
  }
  // The sprites on this strip's rows: with none, the strip is background
  // and its canvas is not read.
  const unsigned on = sprites_on_rows(scene_tab, K, NT, row_begin,
                                      row_begin + rows - 1, lane);
  const int zero_rows = kLanczos ? (rows + 7) & ~7 : rows;
  uint4* canvas16 = reinterpret_cast<uint4*>(canvas);
  if (kLanczos || on != 0u)
    for (int i = tid; i < zero_rows * cp / 16; i += kThreads)
      canvas16[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // ---- fill of the sprites that reach this strip ------------------------ //
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
                           cp, wx, warp, kWarps, lane);
    else
      fill_sprite(st, V, value, r0, r1, c0, c1, row_begin, canvas, cp, wx,
                  ww, warp, kWarps, lane);
  }
  __syncthreads();

  if constexpr (!kLanczos) {  // identity or box: this strip's image rows
    const int aa = hc / h;  // 1 for the identity
    uint8_t* img = out + size_t(scene) * h * w * 3;
    // The box's mixed blocks resolve slots by byte permute for K + 1 <= 8:
    // faster here than the shared table (which the scene kernel takes).
    if (K + 1 <= 8)
      strip_output<kRoute8>(canvas, cp, rows, aa, ds, h, w, row_begin / aa,
                            scene_tab, NT, on, s_ctab, chan, kc, img, warp,
                            lane);
    else
      strip_output<kRouteTable>(canvas, cp, rows, aa, ds, h, w,
                                row_begin / aa, scene_tab, NT, on, s_ctab,
                                chan, kc, img, warp, lane);
  } else {
    // ---- horizontal Lanczos pass on the tensor cores -------------------- //
    // Units of 16 output columns by 8 canvas rows, into this scene's
    // hpT[3][wp][hp] (canvas row y at byte y of a row), rows of this strip
    // only.
    const int mt = (w + 15) >> 4;
    const size_t plane = size_t(16 * mt) * hp;
    uint8_t* hpT = out + size_t(scene) * 3 * plane;
    strip_hpass(canvas, cp, rows, row_begin, ht, mt, chan, kc, hpT, plane, hp,
                warp, lane);
  }
}

// One warp a (scene, 8 output columns): every 16-row m-tile, top to bottom,
// so that neighbouring m-tiles' overlapping windows meet in the L1 cache.
__global__ void __launch_bounds__(kVpassThreads)
strip_vpass_kernel(const uint8_t* __restrict__ hpT, int blocks_per_scene,
                   int hp, int w, int h, Taps vt, uint8_t* __restrict__ out) {
  const int scene = blockIdx.x / blocks_per_scene;
  const int n = (blockIdx.x - scene * blocks_per_scene) * kVpassWarps
                + (threadIdx.x >> 5);
  if (8 * n >= w) return;  // whole warps only
  const int mt_h = (w + 15) >> 4;
  const size_t plane = size_t(16 * mt_h) * hp;
  const uint8_t* src = hpT + size_t(scene) * 3 * plane;
  uint8_t* img = out + size_t(scene) * h * w * 3;
  const int mt_v = (h + 15) >> 4;
  for (int m = 0; m < mt_v; ++m)
    vpass_unit(src, plane, hp, vt, m, 8 * n, h, w, img, threadIdx.x & 31);
}

template <bool kLanczos>
int launch(const float* tab, int B, int K, int V, int NT, int hc, int wc,
           int h, int w, int centroid, int ds, int strip_rows, int cp,
           const Taps& ht, int hp, int bg_packed, uint8_t* out,
           cudaStream_t stream) {
  const Layout L =
      layout(K, kLanczos ? (strip_rows + 7) & ~7 : strip_rows, cp);
  cudaError_t err = cudaFuncSetAttribute(
      strip_raster_kernel<kLanczos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_strips = (hc + strip_rows - 1) / strip_rows;
  strip_raster_kernel<kLanczos><<<B * num_strips, kThreads, L.bytes,
                                  stream>>>(
      tab, K, V, NT, hc, wc, h, w, centroid, ds, strip_rows, num_strips, cp,
      ht, hp, bg_packed, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLanczos>
int blocks_per_sm(long long smem_bytes) {
  int blocks = 0;
  cudaFuncSetAttribute(strip_raster_kernel<kLanczos>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes));
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, strip_raster_kernel<kLanczos>, kThreads,
          static_cast<size_t>(smem_bytes)) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// Shared memory a strip_raster block needs for `rows` canvas rows of `cp`
// bytes (with the Lanczos filter round8(strip_rows) rows at the h-pass taps'
// pitch, otherwise strip_rows rows of wc rounded up to 16); the renderer's
// dispatch checks its Python mirror (rasterize_cuda.strip_smem_bytes)
// against this.
extern "C" long long strip_raster_smem_bytes(int K, int rows, int cp) {
  return static_cast<long long>(layout(K, rows, cp).bytes);
}

// Fill and h-pass (ds == DS_LANCZOS: into hpT u8[B][3][wp][hp], wp = w
// rounded up to 16, canvas row y at byte y of each row, with the h-pass tiles
// of rasterize_cuda.lanczos_tiles and `cp` their input pitch) or the flipped
// image (DS_IDENTITY, or DS_BOX with strip_rows a multiple of
// anti_aliasing; cp = wc rounded up to 16, taps null) of B scenes in
// strips of `strip_rows` canvas rows; `centroid` selects the fill. Launches
// on `stream`; returns the CUDA error code (0 on success).
extern "C" int strip_raster_launch(const float* tab, int B, int K, int V,
                                   int NT, int hc, int wc, int h, int w,
                                   int centroid, int ds, int strip_rows,
                                   int cp, const void* hfrags,
                                   const int* hkstart, const int* hqsum,
                                   int hks, int hp,
                                   int bg_packed, uint8_t* out,
                                   void* stream) {
  const Taps ht{static_cast<const int4*>(hfrags), hkstart, hqsum, hks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ds == DS_LANCZOS
             ? launch<true>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds,
                            strip_rows, cp, ht, hp, bg_packed, out, s)
             : launch<false>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds,
                             strip_rows, cp, ht, hp, bg_packed, out, s);
}

// Vertical pass of B h-pass buffers hpT u8[B][3][wp][hp] (as
// strip_raster_launch writes them) into flipped images u8[B][h][w][3], with
// the v-pass tiles (hc -> h) of rasterize_cuda.lanczos_tiles. Launches on
// `stream`; returns the CUDA error code.
extern "C" int strip_vpass_launch(const uint8_t* hpT, int B, int hp, int w,
                                  int h, const void* vfrags,
                                  const int* vkstart, int vks, uint8_t* out,
                                  void* stream) {
  const int nt = (w + 7) >> 3;
  const int blocks_per_scene = (nt + kVpassWarps - 1) / kVpassWarps;
  const Taps vt{static_cast<const int4*>(vfrags), vkstart, nullptr, vks};
  strip_vpass_kernel<<<B * blocks_per_scene, kVpassThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      hpT, blocks_per_scene, hp, w, h, vt, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of strip_raster_kernel's DS_LANCZOS (`lanczos`) or other
// instantiation resident on one SM at this shared memory.
extern "C" int strip_raster_blocks_per_sm(long long smem_bytes,
                                          int lanczos) {
  return lanczos ? blocks_per_sm<true>(smem_bytes)
                 : blocks_per_sm<false>(smem_bytes);
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
