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
// * With Lanczos the block works only where some sprite's bounds reach,
//   decided from the scene's own table: the plan, a bit a unit. An h-pass
//   unit (16 output columns of 8 canvas rows) is live when a live sprite's
//   row bounds meet its rows and its column bounds meet the input span of
//   its outputs' taps; a v-pass unit (16 output rows of 8 output columns)
//   when a sprite's bounds meet its rows' span and its columns' span. A
//   group of 8 canvas rows with a live h-pass unit is live: only the live
//   groups are zeroed, filled and h-passed, packed into as few bands as
//   fit (two sprites of scale 0.13 at 64x64, anti_aliasing=5: one or two
//   bands, not four). Every input of the other units is the background
//   colour c, so they are Pillow's same integers from the taps' sums: the
//   h-values c * qsum[x] go to hpT where the h-pass units are dead, and the
//   dead v-pass units copy their pixels, (c * qsum[x]) * vqsum[y], from the
//   image of a scene without sprites that the wrapper builds once
//   (rasterize_cuda.scene_background). (Writing hpT only where a live
//   v-pass unit reads it, and copying the dead units before the fill,
//   measured 0.6-2.7% slower.) The live units of each pass go to
//   the warps in turn, m-tile by m-tile (each warp finds them with the same
//   ballots over the plan's bits), so that the warps share one m-tile's
//   taps in the L1 cache. Each block writes its scene's count of live
//   v-pass units to `live` (rasterize_cuda's `scene_raster.live_units`).
//   On the four cells' scenes 31% (goal finding), 55% (the embodied
//   example) and 76% (the compositional example) of the v-pass units are
//   live.
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
// DS_LANCZOS, whose tensor-core passes take ~100 registers a thread, held
// to 128 so that two of its blocks share an SM's 64 Ki registers.
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
  size_t canvas, chan, hpass, plan, bytes;
};

__host__ __device__ inline int band_rows(int hc) {
  return min((hc + 7) & ~7, kBandRows);
}

// With DS_LANCZOS, the plan of the live units, in 4-byte words: each
// sprite's bounds (row0, row1, col0, col1; empty for a dead slot), the
// count of live groups of 8 canvas rows and the live groups in order, a
// bit a h-pass unit (m-tile m of canvas rows 8g .. 8g + 7: bit g % 32 of
// word m * nhw + g / 32, nhw = ceil(ng / 32)) and a bit a v-pass unit (u =
// m * nt_v + n: bit u % 32 of word u / 32, after them), set where it is
// live. `ng` groups, `mt_h` h-pass m-tiles, `nv` v-pass units.
struct Plan {
  int nlg, glist, hmask, vmask, words;
};

__host__ __device__ inline Plan plan_layout(int K, int ng, int mt_h,
                                            int nv) {
  Plan P;
  P.nlg = 4 * K;
  P.glist = P.nlg + 1;
  P.hmask = P.glist + ng;
  P.vmask = P.hmask + mt_h * ((ng + 31) >> 5);
  P.words = P.vmask + ((nv + 31) >> 5);
  return P;
}

// `cp` is the canvas pitch: wc rounded up to 16 outside DS_LANCZOS, else
// the h-pass taps'. With DS_LANCZOS (hp > 0) the canvas holds one band of
// band_rows(hc) rows, and the channel tables, the h-pass buffer
// hpT[3][wp][hp] and the plan follow. With the box filter it holds one
// group of `aa` rows (one output row's) for each warp, and at
// anti_aliasing=1 (the identity) the whole canvas, so that the dispatch of
// those canvases stays as it was; the channel tables follow.
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
  L.plan = L.hpass + (hp ? round16(size_t(3) * wp * hp) : 0);
  L.bytes = L.plan;
  if (hp) {
    const int h = hc / aa;
    L.bytes += round16(size_t(4) * plan_layout(K, (hc + 7) >> 3, wp >> 4,
                                               ((h + 15) >> 4) * (wp >> 3))
                                       .words);
  }
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

// h-pass of the live units of a band of live groups glist[0, nb) (group
// glist[j] held at rows 8j .. 8j + 7 of `canvas`), into hpT[3][wp][hp]
// (canvas row y at byte y of a row), a unit a warp: m-tile m of group g is
// live where bit g of the m-tile's words `hmask[m * nhw ..]` is set. The
// live units go to the block's warps in turn, m-tile by m-tile, so that
// the warps share one m-tile's taps in the L1 cache; every warp finds them
// by the same ballots.
template <int kRoute>
__device__ void hpass_units(const uint8_t* canvas, int cp,
                            const unsigned* hmask, int nhw, const int* glist,
                            int nb, const Taps& ht, int mt,
                            const uint8_t* chan, int kc, uint8_t* hpT,
                            size_t plane, int hp, int warp, int num_warps,
                            int lane) {
  ChanRegs regs;
  if (kRoute != kRouteTable) load_chan_regs(regs, chan, kc);
  int dealt = 0;  // live units before this round of 32
  for (int base = 0; base < mt * nb; base += 32) {  // warp-uniform
    const int i = base + lane, m = i / nb, j = i - m * nb, g = glist[j];
    const bool keep =
        i < mt * nb && ((hmask[m * nhw + (g >> 5)] >> (g & 31)) & 1u);
    const unsigned bits = __ballot_sync(kFull, keep);
    const int n = __popc(bits);
    for (int r = ((warp - dealt) % num_warps + num_warps) % num_warps; r < n;
         r += num_warps) {
      const int src = __fns(bits, 0, r + 1);
      hpass_unit<kRoute>(canvas, cp, 8 * __shfl_sync(kFull, j, src), ht,
                         __shfl_sync(kFull, m, src), regs, chan, kc, hpT,
                         plane, hp, 8 * __shfl_sync(kFull, g, src), hp, lane);
    }
    dealt += n;
  }
}

// Whether some sprite's `bounds` (row0, row1, col0, col1) meet canvas
// rows [r0, r1] and columns [c0, c1]. Outside every live sprite's bounds
// the canvas holds the background.
__device__ __forceinline__ bool sprite_meets(const float4* bounds, int K,
                                             int r0, int r1, int c0,
                                             int c1) {
  bool any = false;
  for (int k = 0; k < K; ++k) {
    const float4 b = bounds[k];
    any |= (b.x <= r1) & (b.y >= r0) & (b.z <= c1) & (b.w >= c0);
  }
  return any;
}

// The input span [lo, hi) of a pass's outputs 8 * b0 .. 8 * b1 + 7, from
// the host's spans of 8-output blocks (`span` i32[blocks][2]).
__device__ __forceinline__ int2 span_of(const int* span, int b0, int b1) {
  return make_int2(min(__ldg(span + 2 * b0), __ldg(span + 2 * b1)),
                   max(__ldg(span + 2 * b0 + 1), __ldg(span + 2 * b1 + 1)));
}

// Pillow's value of a pass over a window of the one value v: clip8 of
// 2^21 + v * qsum (qsum the output's sum of taps), as `combine` gives it.
__device__ __forceinline__ unsigned uniform_value(int v, int qsum) {
  return clip8(static_cast<int>((1u << 21) + static_cast<uint32_t>(v * qsum)));
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
__global__ void __launch_bounds__(threads_of(kLanczos), kLanczos ? 2 : 3)
scene_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                    int hc, int wc, int h, int w, int centroid, int ds,
                    Taps ht, const int* __restrict__ hspan, int cp, Taps vt,
                    const int* __restrict__ vspan, int hp, int bg_packed,
                    const uint8_t* __restrict__ bg_img,
                    uint8_t* __restrict__ out, int* __restrict__ live) {
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
    const size_t plane = size_t(wp) * hp;
    const int ng = (hc + 7) >> 3, mt_v = (h + 15) >> 4, nt_v = (w + 7) >> 3;
    const int nv = mt_v * nt_v, nbv = (h + 7) >> 3;
    const int nhw = (ng + 31) >> 5, nvw = (nv + 31) >> 5;
    const Plan P = plan_layout(K, ng, mt_h, mt_v * (wp >> 3));
    int* plan = reinterpret_cast<int*>(smem + L.plan);
    const float4* bounds = reinterpret_cast<const float4*>(plan);
    int* glist = plan + P.glist;
    unsigned* hmask = reinterpret_cast<unsigned*>(plan + P.hmask);
    const unsigned* vmask = reinterpret_cast<unsigned*>(plan + P.vmask);
    for (int k = tid; k < K; k += kThreads) {
      const float* st = scene + k * NT;
      reinterpret_cast<float4*>(plan)[k] =
          st[T_COUNT] > 0.f
              ? make_float4(st[T_ROW0], st[T_ROW1], st[T_COL0], st[T_COL1])
              : make_float4(kBig, -kBig, kBig, -kBig);
    }
    __syncthreads();  // s_tab, chan, bounds
    // ---- the plan: a bit a unit that some sprite's bounds reach, a word
    // a warp (the h-pass units' words, then the v-pass units') ----------- //
    for (int word = warp; word < mt_h * nhw + nvw; word += kWarps) {
      bool keep = false;
      if (word < mt_h * nhw) {
        const int m = word / nhw, g = 32 * (word - m * nhw) + lane;
        const int2 cols = span_of(hspan, 2 * m, min(2 * m + 1, nt_v - 1));
        keep = g < ng && sprite_meets(bounds, K, 8 * g, 8 * g + 7, cols.x,
                                      cols.y - 1);
      } else {
        const int u = 32 * (word - mt_h * nhw) + lane;
        const int m = u / nt_v, n = u - m * nt_v;
        if (u < nv) {
          const int2 rows = span_of(vspan, 2 * m, min(2 * m + 1, nbv - 1));
          const int2 cols = span_of(hspan, n, n);
          keep = sprite_meets(bounds, K, rows.x, rows.y - 1, cols.x,
                              cols.y - 1);
        }
      }
      const unsigned bits = __ballot_sync(kFull, keep);
      if (lane == 0) hmask[word] = bits;  // vmask follows hmask
    }
    __syncthreads();  // the masks
    // ---- warp 0: the live groups (a live h-pass unit each), in order;
    // the others: the background's h-values (c * qsum[x] of each channel)
    // where the h-pass units are dead, a group's 8 bytes of a row of hpT -- //
    if (warp == 0) {
      int count = 0;
      for (int k = 0; k < nhw; ++k) {
        unsigned any = 0u;
        for (int m = 0; m < mt_h; ++m) any |= hmask[m * nhw + k];
        if ((any >> lane) & 1u)
          glist[count + __popc(any & ((1u << lane) - 1u))] = 32 * k + lane;
        count += __popc(any);
      }
      if (lane == 0) plan[P.nlg] = count;
    }
    for (int i = tid - 32; warp > 0 && i < 3 * wp; i += kThreads - 32) {
      const int ch = i / wp, x = i - ch * wp;
      const unsigned v = uniform_value(chan[ch * kc], __ldg(ht.qsum + x));
      const uint2 v8 = make_uint2(v * 0x01010101u, v * 0x01010101u);
      uint2* row = reinterpret_cast<uint2*>(hpT + ch * plane + size_t(x) * hp);
      const unsigned* live_groups = hmask + (x >> 4) * nhw;
      for (int k = 0; k < nhw; ++k) {
        unsigned dead = ~live_groups[k];
        if (ng - 32 * k < 32) dead &= (1u << (ng - 32 * k)) - 1u;
        for (; dead; dead &= dead - 1u) row[32 * k + __ffs(dead) - 1] = v8;
      }
    }
    __syncthreads();  // glist, the count
    const int nlg = plan[P.nlg];
    // ---- fill and h-pass the live groups, band by band ------------------ //
    const int per_band = band_rows(hc) >> 3, route = route_of(K);
    for (int b0 = 0; b0 < nlg; b0 += per_band) {
      const int nb = min(per_band, nlg - b0);
      zero(canvas, size_t(8 * nb) * cp, tid, kThreads);
      __syncthreads();  // also: the previous band's h-pass is done
      for (int j = 0; j < nb;) {  // runs of consecutive groups
        const int g0 = glist[b0 + j];
        int run = 1;
        while (j + run < nb && glist[b0 + j + run] == g0 + run) ++run;
        fill_rows(s_tab, K, V, NT, 8 * g0, min(8 * run, hc - 8 * g0), wc,
                  centroid, canvas + size_t(8 * j) * cp, cp, wx, ww, warp,
                  kWarps, lane);
        j += run;
      }
      __syncthreads();
      if (route == kRoute8)
        hpass_units<kRoute8>(canvas, cp, hmask, nhw, glist + b0, nb, ht,
                             mt_h, chan, kc, hpT, plane, hp, warp, kWarps,
                             lane);
      else if (route == kRoute16)
        hpass_units<kRoute16>(canvas, cp, hmask, nhw, glist + b0, nb, ht,
                              mt_h, chan, kc, hpT, plane, hp, warp, kWarps,
                              lane);
      else
        hpass_units<kRouteTable>(canvas, cp, hmask, nhw, glist + b0, nb, ht,
                                 mt_h, chan, kc, hpT, plane, hp, warp,
                                 kWarps, lane);
      __syncthreads();
    }
    // ---- vertical pass of the live units, in turn over the warps: 16
    // output rows by 8 output columns a unit, written flipped ------------ //
    int nvl = 0;
    for (int k = 0; k < nvw; ++k) {
      const unsigned bits = vmask[k];
      const int n = __popc(bits);
      for (int r = ((warp - nvl) % kWarps + kWarps) % kWarps; r < n;
           r += kWarps) {
        const int u = 32 * k + __fns(bits, 0, r + 1);
        vpass_unit(hpT, plane, hp, vt, u / nt_v, 8 * (u % nt_v), h, w, img,
                   lane);
      }
      nvl += n;
    }
    if (tid == 0 && live) live[blockIdx.x] = nvl;
    // ---- the dead units' pixels, a unit row (8 pixels) a thread, from
    // the background image: Pillow's (c * qsum[x]) * vqsum[y] ------------ //
    const bool words = (w & 7) == 0;  // unit rows whole, 8-byte aligned
    for (int i = tid; i < (nv - nvl) * 16; i += kThreads) {
      int d = i >> 4, u = 0;  // the d-th dead unit
      for (int k = 0; k < nvw; ++k) {
        unsigned dead = ~vmask[k];
        if (nv - 32 * k < 32) dead &= (1u << (nv - 32 * k)) - 1u;
        if (d < __popc(dead)) {
          u = 32 * k + __fns(dead, 0, d + 1);
          break;
        }
        d -= __popc(dead);
      }
      const int oy = 16 * (u / nt_v) + (i & 15), x0 = 8 * (u % nt_v);
      if (oy >= h) continue;
      const size_t at = (size_t(h - 1 - oy) * w + x0) * 3;
      if (words) {
        const uint2* src = reinterpret_cast<const uint2*>(bg_img + at);
        uint2* dst = reinterpret_cast<uint2*>(img + at);
        dst[0] = __ldg(src);
        dst[1] = __ldg(src + 1);
        dst[2] = __ldg(src + 2);
      } else {
        for (int j = 0; j < 3 * min(8, w - x0); ++j)
          img[at + j] = bg_img[at + j];
      }
    }
  }
}

template <bool kLanczos>
int launch(const float* tab, int B, int K, int V, int NT, int hc, int wc,
           int h, int w, int centroid, int ds, const Taps& ht,
           const int* hspan, int cp, const Taps& vt, const int* vspan,
           int hp, int bg_packed, const uint8_t* bg_img, uint8_t* out,
           int* live, cudaStream_t stream) {
  const int wp = 16 * ((w + 15) >> 4);
  const Layout L = layout(K, NT, hc, hc / h, cp, wp, kLanczos ? hp : 0);
  cudaError_t err = cudaFuncSetAttribute(
      scene_raster_kernel<kLanczos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  scene_raster_kernel<kLanczos><<<B, threads_of(kLanczos), L.bytes,
                                  stream>>>(
      tab, K, V, NT, hc, wc, h, w, centroid, ds, ht, hspan, cp, vt, vspan,
      hp, bg_packed, bg_img, out, live);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
// `centroid` selects the fill (tables of prepare(pil_exact=False)), `ds` the
// downsample (DS_IDENTITY, DS_LANCZOS or DS_BOX). With DS_LANCZOS the taps
// are the h-pass's (wc -> w) and the v-pass's (hc -> h) tiles of
// rasterize_cuda.lanczos_tiles, with the h-pass's tap sums and each pass's
// spans of 8-output blocks (`span8`), `cp` the h-pass's input pitch and
// `hp` the v-pass's, `bg_img` the image of a scene without sprites
// (u8[h][w][3] as the kernel writes it, rasterize_cuda.scene_background),
// and each scene's count of live v-pass units goes to live[B] unless it is
// null; otherwise cp = wc rounded up to 16, hp = 0 and the tap and image
// pointers may be null.
extern "C" int scene_raster_launch(const float* tab, int B, int K, int V,
                                   int NT, int hc, int wc, int h, int w,
                                   int centroid, int ds, const void* hfrags,
                                   const int* hkstart, const int* hqsum,
                                   const int* hspan, int hks, int cp,
                                   const void* vfrags, const int* vkstart,
                                   const int* vspan, int vks, int hp,
                                   int bg_packed, const uint8_t* bg_img,
                                   uint8_t* out, int* live, void* stream) {
  const Taps ht{static_cast<const int4*>(hfrags), hkstart, hqsum, hks};
  const Taps vt{static_cast<const int4*>(vfrags), vkstart, nullptr, vks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ds == DS_LANCZOS
             ? launch<true>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds, ht,
                            hspan, cp, vt, vspan, hp, bg_packed, bg_img, out,
                            live, s)
             : launch<false>(tab, B, K, V, NT, hc, wc, h, w, centroid, ds,
                             ht, hspan, cp, vt, vspan, hp, bg_packed, bg_img,
                             out, live, s);
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
