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
// is per filled-region pixel a test of the row's compacted crossings (~2)
// and per output ~31 multiply-adds per channel and pass (Lanczos) or aa*aa
// adds (box). The Lanczos multiply-adds run on the int8 tensor cores; the
// fill's serial per-row warp reductions are what the kernel pays most. With
// the centroid fill and the box filter (pil_exact=False) the kernel issues
// instructions back to back: a crossing per row and edge, a few operations
// per pixel of a sprite's bounds, a compare per word of a box block.
//
// Design.
// * The TPU kernel keeps an f32 packed-RGB canvas (400 KiB at 320x320) and
//   f32 crossing and weight tables (288 KiB each) in VMEM. None fits the
//   227 KiB of shared memory a block may use. Here the canvas holds the
//   index of the topmost sprite of each pixel, one byte (0 = background,
//   k + 1 = sprite k). Later sprites overwrite earlier ones (painter's
//   order); colours stay in a K + 1 entry table.
// * Crossings are recomputed per (row, edge) instead of stored, one warp per
//   canvas row and one lane per edge, and compacted to the row's few by
//   ballot: the fills are `sw::fill_sprite` and `sw::fill_sprite_centroid`
//   of raster_fill.cuh, which the row-strip and anti_aliasing=1 kernels
//   share. The centroid crossing is computed with ops/geometry.py's
//   roundings, not the TPU kernel's x0 + (row - y0) * m, so the kernel
//   equals the port's CPU centroid fill bit for bit. (Centroid fills that
//   wrote 32-bit words from integer column thresholds measured no faster
//   here and slower in the row-strip kernel; PERF.md has the runs.)
// * The Lanczos filter runs in Pillow's own fixed point, exactly, on the
//   int8 tensor cores (lanczos_mma.cuh): each pass is a banded product of
//   the taps, split into u8/u8/s8 limbs, by u8 pixels, three mma.sync a K
//   step. The h-pass resolves slot bytes to one channel with byte permutes
//   and writes the transposed, channel-planar buffer hpT[3][wp][hp] (64 KiB
//   at 320x64), whose rows are the v-pass's K-contiguous operand; a window
//   of one slot throughout skips the products (colour times tap sum). The
//   v-pass writes the output already flipped.
// * With Lanczos the canvas is filled and h-passed in bands of kBandRows
//   rows, so only a band (26 KiB at 320 wide) sits beside hpT, and the
//   instantiation runs 8 warps a block: at 64x64, anti_aliasing=5 its ~100
//   KiB of shared memory and ~100 registers a thread let two blocks share an
//   SM, so one block's fill overlaps the other's tensor-core passes.
// * The identity and box modes (a separate instantiation of 16 warps,
//   without the passes' registers) need no barrier between rows: each warp
//   renders whole output rows, one at a time, from its own group of aa
//   canvas rows (25.6 KB for the block at 64x64, anti_aliasing=5, so three
//   blocks share an SM), zeroing, filling and filtering it alone. A row no
//   sprite's bounds reach is background and reads no canvas, nor does an
//   output whose columns meet no sprite's bounds.
// * The box filter (`sw::box_words`) compares the words of each aa x aa
//   block with its first slot: a block of one slot (94% at image64/AA=5) is
//   that slot's colour; the warp sums the others together by words, with
//   byte permutes and __dp4a, in integers, and divides once. It needs
//   neither taps nor the h-pass buffer; the TPU kernel multiplied by 1/aa
//   matrices on the MXU instead.
// * A canvas whose layout does not fit one block's shared memory goes to
//   the row-strip kernel instead.
// * Left out: the TPU kernel's single-interval fast path for convex sprites
//   (`_scene_fastok`), a speed trick with the same output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanczos_mma.cuh"
#include "raster_fill.cuh"

namespace {

using namespace sw;

// Threads a block: 512 for the fill-only modes (identity, box); 256 with
// DS_LANCZOS, whose tensor-core passes take ~100 registers a thread, so
// that two of its blocks share an SM's 64 Ki registers.
__host__ __device__ constexpr int threads_of(bool lanczos) {
  return lanczos ? 256 : 512;
}
// With DS_LANCZOS the canvas is filled and h-passed in bands of at most
// this many rows (a multiple of 8), so that at 64x64, anti_aliasing=5 the
// band, the h-pass buffer and the tables fit two blocks on one SM.
constexpr int kBandRows = 80;

struct Layout {
  // Word offsets (4 bytes) of the small tables, byte offsets of the u8 ones.
  int tab, ctab, xi, wgt;
  size_t canvas, chan, hpass, bytes;
};

__host__ __device__ inline int band_rows(int hc) {
  return min((hc + 7) & ~7, kBandRows);
}

// `cp` is the canvas pitch: wc rounded up to 16 outside DS_LANCZOS, else
// the h-pass taps'. With DS_LANCZOS (hp > 0) the canvas holds one band of
// band_rows(hc) rows, and the channel tables and the h-pass buffer
// hpT[3][wp][hp] follow. With the box filter it holds one group of `aa` rows
// (one output row's) for each warp, and at anti_aliasing=1 (the identity)
// the whole canvas, so that the dispatch of those canvases stays as it was;
// the channel tables follow.
__host__ __device__ inline Layout layout(int K, int NT, int hc, int aa,
                                         int cp, int wp, int hp) {
  Layout L;
  L.tab = 0;
  L.ctab = L.tab + K * NT;
  L.xi = L.ctab + K + 1;
  const int warps = threads_of(hp > 0) / 32;
  L.wgt = L.xi + warps * 32;
  L.canvas = round16(size_t(L.wgt + warps * 32) * 4);
  const int rows = hp ? band_rows(hc) : (aa == 1 ? hc : warps * aa);
  L.chan = L.canvas + round16(size_t(rows) * cp);
  L.hpass = L.chan + round16(size_t(3) * chan_stride(K));
  L.bytes = L.hpass + (hp ? round16(size_t(3) * wp * hp) : 0);
  return L;
}

// Paints canvas rows [row0, row0 + rows) of every live sprite, back to
// front, into `canvas` (which holds those rows, `cp` bytes each).
__device__ __forceinline__ void fill_rows(const float* s_tab, int K, int V,
                                          int NT, int row0, int rows, int wc,
                                          int centroid, uint8_t* canvas,
                                          int cp, float* wx, int* ww,
                                          int warp, int num_warps,
                                          int lane) {
  for (int k = 0; k < K; ++k) {
    const float* st = s_tab + k * NT;
    if (static_cast<int>(st[T_COUNT]) <= 0) continue;
    const int r0 = max(static_cast<int>(st[T_ROW0]), row0);
    const int r1 = min(static_cast<int>(st[T_ROW1]), row0 + rows - 1);
    if (r0 > r1) continue;  // the sprite misses these rows
    const uint8_t value = static_cast<uint8_t>(k + 1);
    const int c0 = max(static_cast<int>(st[T_COL0]), 0);
    const int c1 = min(static_cast<int>(st[T_COL1]), wc - 1);
    if (centroid)
      fill_sprite_centroid(st, V, value, r0, r1, c0, c1, row0, canvas, cp,
                           wx, warp, num_warps, lane);
    else
      fill_sprite(st, V, value, r0, r1, c0, c1, row0, canvas, cp, wx, ww,
                  warp, num_warps, lane);
  }
}

// h-pass of canvas rows [row0, row0 + round8(rows)) held in `canvas`:
// units of 16 output columns by 8 rows, into hpT[3][wp][hp] (canvas row y
// at byte y of a row). Row tiles vary fastest, so the block's warps share
// an m-tile's taps in the L1 cache.
template <int kRoute>
__device__ void hpass_rows(const uint8_t* canvas, int cp, int row0,
                           int rows, const Taps& ht, int mt,
                           const uint8_t* chan, int kc, uint8_t* hpT,
                           size_t plane, int hp, int warp, int num_warps,
                           int lane) {
  ChanRegs regs;
  if (kRoute != kRouteTable) load_chan_regs(regs, chan, kc);
  const int nt = (rows + 7) >> 3;
  for (int u = warp; u < mt * nt; u += num_warps) {
    const int m = u / nt, n = u % nt;
    hpass_unit<kRoute>(canvas, cp, 8 * n, ht, m, regs, chan, kc, hpT, plane,
                       hp, row0 + 8 * n, hp, lane);
  }
}

// Zeroes `bytes` (a multiple of 16) at the 16-byte aligned `p`, with the
// `threads` threads from `tid` on.
__device__ __forceinline__ void zero(uint8_t* p, size_t bytes, int tid,
                                     int threads) {
  uint4* p16 = reinterpret_cast<uint4*>(p);
  for (size_t i = tid; i < bytes / 16; i += threads)
    p16[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The output row of the warp's group of aa canvas rows `group`, 32 pixels
// at a time (`output_pixel`; `on`: sprites_on_rows of the group's rows).
template <int kRoute>
__device__ __forceinline__ void group_row(const uint8_t* group, int cp,
                                          int aa, int ds, int w,
                                          const float* tab, int NT,
                                          unsigned on, const int* ctab,
                                          const uint8_t* chan, int kc,
                                          uint8_t* orow, int lane) {
  ChanRegs regs;
  if (kRoute != kRouteTable) load_chan_regs(regs, chan, kc);
  for (int x0 = 0; x0 < w; x0 += 32) {  // warp-uniform
    const int x = x0 + lane;
    output_pixel<kRoute>(group, cp, aa, ds, 0, x, w, tab, NT, on, ctab, regs,
                         chan, kc, orow + 3 * x, lane);
  }
}

// kLanczos: the DS_LANCZOS instantiation. The others (identity, box) leave
// out the tensor-core passes and so keep the fill's small register count,
// which lets two blocks share an SM where their shared memory allows.
template <bool kLanczos>
__global__ void __launch_bounds__(threads_of(kLanczos), kLanczos ? 1 : 3)
scene_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                    int hc, int wc, int h, int w, int centroid, int ds,
                    Taps ht, int cp, Taps vt, int hp, int bg_packed,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mt_h = (w + 15) >> 4, wp = 16 * mt_h;
  const Layout L = layout(K, NT, hc, hc / h, cp, wp, kLanczos ? hp : 0);
  float* s_tab = reinterpret_cast<float*>(smem) + L.tab;
  int* s_ctab = reinterpret_cast<int*>(smem) + L.ctab;
  float* s_xi = reinterpret_cast<float*>(smem) + L.xi;
  int* s_wgt = reinterpret_cast<int*>(smem) + L.wgt;
  uint8_t* canvas = smem + L.canvas;

  constexpr int kThreads = threads_of(kLanczos), kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* wx = s_xi + warp * 32;
  int* ww = s_wgt + warp * 32;
  const float* scene = tab + size_t(blockIdx.x) * K * NT;
  for (int i = tid; i < K * NT; i += kThreads) s_tab[i] = scene[i];
  for (int i = tid; i <= K; i += kThreads)
    s_ctab[i] = i == 0 ? bg_packed
                       : static_cast<int>(scene[(i - 1) * NT + T_COLOR]);
  uint8_t* img = out + size_t(blockIdx.x) * h * w * 3;

  const int kc = chan_stride(K);
  uint8_t* chan = smem + L.chan;
  __syncthreads();  // s_ctab
  for (int i = tid; i < 3 * kc; i += kThreads) {
    const int ch = i / kc, slot = i - ch * kc;
    const int c = slot <= K ? s_ctab[slot] : 0;
    chan[i] = static_cast<uint8_t>(c >> (16 - 8 * ch));
  }

  if constexpr (!kLanczos) {
    // ---- identity or box: each warp renders whole output rows, one at a
    // time, from its own group of aa canvas rows, so no block barrier ---- //
    const int aa = hc / h;
    __syncthreads();  // s_tab, chan
    for (int y = warp; y < h; y += kWarps) {
      uint8_t* group = canvas + size_t(aa == 1 ? y : warp * aa) * cp;
      const unsigned on =
          sprites_on_rows(s_tab, K, NT, y * aa, y * aa + aa - 1, lane);
      if (on != 0u) {  // else the row is background: no canvas is read
        zero(group, size_t(aa) * cp, lane, 32);
        __syncwarp();
        fill_rows(s_tab, K, V, NT, y * aa, aa, wc, centroid, group, cp, wx,
                  ww, 0, 1, lane);
        __syncwarp();
      }
      uint8_t* orow = img + size_t(h - 1 - y) * w * 3;
      // The box's mixed blocks resolve slots through the shared table for
      // every K: at the 40 registers three blocks an SM allow, this ran
      // faster here than the permute route (which the strip kernel keeps).
      group_row<kRouteTable>(group, cp, aa, ds, w, s_tab, NT, on, s_ctab,
                             chan, kc, orow, lane);
      __syncwarp();  // the group read before it is zeroed again
    }
  } else {
    uint8_t* hpT = smem + L.hpass;
    // ---- fill and h-pass, band by band ---------------------------------- //
    const size_t plane = size_t(wp) * hp;
    const int band = band_rows(hc), route = route_of(K);
    for (int row0 = 0; row0 < hc; row0 += band) {
      const int rows = min(band, hc - row0);
      zero(canvas, size_t((rows + 7) & ~7) * cp, tid, kThreads);
      __syncthreads();  // also: the previous band's h-pass is done
      fill_rows(s_tab, K, V, NT, row0, rows, wc, centroid, canvas, cp, wx,
                ww, warp, kWarps, lane);
      __syncthreads();
      if (route == kRoute8)
        hpass_rows<kRoute8>(canvas, cp, row0, rows, ht, mt_h, chan, kc, hpT,
                            plane, hp, warp, kWarps, lane);
      else if (route == kRoute16)
        hpass_rows<kRoute16>(canvas, cp, row0, rows, ht, mt_h, chan, kc, hpT,
                             plane, hp, warp, kWarps, lane);
      else
        hpass_rows<kRouteTable>(canvas, cp, row0, rows, ht, mt_h, chan, kc,
                                hpT, plane, hp, warp, kWarps, lane);
      __syncthreads();
    }
    // ---- vertical pass: 16 output rows by 8 output columns a unit,
    // written flipped ---------------------------------------------------- //
    const int mt_v = (h + 15) >> 4, nt_v = (w + 7) >> 3;
    for (int u = warp; u < mt_v * nt_v; u += kWarps) {
      const int m = u % mt_v, n = u / mt_v;
      vpass_unit(hpT, plane, hp, vt, m, 8 * n, h, w, img, lane);
    }
  }
}

template <bool kLanczos>
int launch(const float* tab, int B, int K, int V, int NT, int hc, int wc,
           int h, int w, int centroid, int ds, const Taps& ht, int cp,
           const Taps& vt, int hp, int bg_packed, uint8_t* out,
           cudaStream_t stream) {
  const int wp = 16 * ((w + 15) >> 4);
  const Layout L = layout(K, NT, hc, hc / h, cp, wp, kLanczos ? hp : 0);
  cudaError_t err = cudaFuncSetAttribute(
      scene_raster_kernel<kLanczos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  scene_raster_kernel<kLanczos><<<B, threads_of(kLanczos), L.bytes,
                                  stream>>>(
      tab, K, V, NT, hc, wc, h, w, centroid, ds, ht, cp, vt, hp, bg_packed,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
// `centroid` selects the fill (tables of prepare(pil_exact=False)), `ds` the
// downsample (DS_IDENTITY, DS_LANCZOS or DS_BOX). With DS_LANCZOS the taps
// are the h-pass's (wc -> w) and the v-pass's (hc -> h) tiles of
// rasterize_cuda.lanczos_tiles, `cp` the h-pass's input pitch and `hp` the
// v-pass's; otherwise cp = wc rounded up to 16, hp = 0 and the tap
// pointers may be null.
extern "C" int scene_raster_launch(const float* tab, int B, int K, int V,
                                   int NT, int hc, int wc, int h, int w,
                                   int centroid, int ds, const void* hfrags,
                                   const int* hkstart, const int* hqsum,
                                   int hks, int cp,
                                   const void* vfrags, const int* vkstart,
                                   int vks, int hp, int bg_packed,
                                   uint8_t* out, void* stream) {
  const Taps ht{static_cast<const int4*>(hfrags), hkstart, hqsum, hks};
  const Taps vt{static_cast<const int4*>(vfrags), vkstart, nullptr, vks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ds == DS_LANCZOS
             ? launch<true>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds, ht,
                            cp, vt, hp, bg_packed, out, s)
             : launch<false>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds,
                             ht, cp, vt, hp, bg_packed, out, s);
}

// Dynamic shared memory the kernel needs for these sizes: `aa` the
// anti_aliasing, `cp` the canvas pitch, `wp` and `hp` the h-pass buffer's
// rows and pitch (hp = 0 outside DS_LANCZOS); the renderer's dispatch
// compares its Python mirror
// (rasterize_cuda.scene_smem_bytes) with the card's per-block limit before
// launching.
extern "C" long long scene_raster_smem_bytes(int K, int NT, int hc, int aa,
                                             int cp, int wp, int hp) {
  return static_cast<long long>(layout(K, NT, hc, aa, cp, wp, hp).bytes);
}

template <bool kLanczos>
int blocks_per_sm(long long smem_bytes) {
  int blocks = 0;
  cudaFuncSetAttribute(scene_raster_kernel<kLanczos>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes));
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, scene_raster_kernel<kLanczos>, threads_of(kLanczos),
          static_cast<size_t>(smem_bytes)) != cudaSuccess)
    return -1;
  return blocks;
}

// Blocks of the kernel's DS_LANCZOS (`lanczos`) or other instantiation
// resident on one SM at this shared memory.
extern "C" int scene_raster_blocks_per_sm(long long smem_bytes,
                                          int lanczos) {
  return lanczos ? blocks_per_sm<true>(smem_bytes)
                 : blocks_per_sm<false>(smem_bytes);
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
