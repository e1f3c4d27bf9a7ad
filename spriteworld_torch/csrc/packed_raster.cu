// Small-canvas rasterizer at anti_aliasing=1 for Hopper (sm_90a): one
// four-warp thread block renders one scene (or one tile of its rows).
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
// What bounds it. At 64x64 a scene's output is 12 KiB and its tables ~8 KB,
// so at 2048 scenes ~42 MB: ~0.012 ms at 3.35 TB/s. The fill tests every
// pixel of a sprite's bounds against the row's few crossings, compacted by
// ballot (both fills): a few hundred million operations at 2048 scenes of
// 6 sprites, a few microseconds at 67 TFLOP/s (chip_smoke.py counts them
// from the tables, at every edge for the exact fill).
// So the bound is the bytes; what the kernel pays in practice is latency,
// the serial per-row warp reductions of the fill.
//
// Design.
// * The TPU kernel flattened the frame to [h*w/128, 128] so that a 64-wide
//   canvas would fill the vector unit's 128 lanes. On Hopper lanes are
//   threads and nothing is lost to a narrow canvas, so the frame stays a
//   plain u8 top-slot canvas (0 = background, k + 1 = sprite k) in shared
//   memory, 4 KiB at 64x64, and the flip is folded into the output's row
//   address, as the TPU kernel folded it into its row map.
// * What the small canvas asks for is enough blocks in flight. One block of
//   4 warps a scene needs ~5 KiB of shared memory, so 16 blocks (64 warps,
//   the most an SM holds) fit each SM: 2048 scenes on 132 SMs run in one
//   wave. The scene kernel's 16-warp block (one per SM) would leave most of
//   the SM to a single scene's serial row loops.
// * The fills are `sw::fill_sprite` and `sw::fill_sprite_centroid` of
//   raster_fill.cuh, as in the scene and row-strip kernels, so at
//   anti_aliasing=1 the three kernels agree bit for bit. Canvas row r
//   belongs to warp r % 4 for every sprite, so the painter's order needs no
//   block barrier between sprites. Sprite tables are read from device
//   memory through the L1 cache.
// * A canvas taller than the block's canvas budget (the packed rule admits
//   any height that is not a multiple of 8) is cut into tiles of rows, one
//   block each; at the usual sizes a scene is one tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_fill.cuh"

namespace {

using namespace sw;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Layout {
  // Word offsets of the colour table and crossing scratch, byte offset of
  // the canvas tile.
  int ctab, xi, wgt;
  size_t canvas, bytes;
};

__host__ __device__ inline Layout layout(int K, int tile_rows, int w) {
  Layout L;
  L.ctab = 0;
  L.xi = L.ctab + K + 1;
  L.wgt = L.xi + kWarps * 32;
  L.canvas = round16(size_t(L.wgt + kWarps * 32) * 4);
  L.bytes = L.canvas + round16(size_t(tile_rows) * w);
  return L;
}

__global__ void __launch_bounds__(kThreads)
packed_raster_kernel(const float* __restrict__ tab, int K, int V, int NT,
                     int h, int w, int centroid, int tile_rows,
                     int num_tiles, int bg_packed,
                     uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(K, tile_rows, w);
  int* s_ctab = reinterpret_cast<int*>(smem) + L.ctab;
  float* s_xi = reinterpret_cast<float*>(smem) + L.xi;
  int* s_wgt = reinterpret_cast<int*>(smem) + L.wgt;
  uint8_t* canvas = smem + L.canvas;

  const int tid = threadIdx.x;
  const int scene = blockIdx.x / num_tiles;
  const int row_begin = (blockIdx.x - scene * num_tiles) * tile_rows;
  const int rows = min(tile_rows, h - row_begin);
  const float* scene_tab = tab + size_t(scene) * K * NT;
  for (int i = tid; i <= K; i += kThreads)
    s_ctab[i] = i == 0 ? bg_packed
                       : static_cast<int>(scene_tab[(i - 1) * NT + T_COLOR]);
  uint32_t* canvas32 = reinterpret_cast<uint32_t*>(canvas);
  for (int i = tid; i < (rows * w + 3) / 4; i += kThreads) canvas32[i] = 0u;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  float* wx = s_xi + warp * 32;
  int* ww = s_wgt + warp * 32;
  for (int k = 0; k < K; ++k) {
    const float* st = scene_tab + k * NT;
    if (static_cast<int>(st[T_COUNT]) <= 0) continue;
    const int r0 = max(static_cast<int>(st[T_ROW0]), row_begin);
    const int r1 = min(static_cast<int>(st[T_ROW1]), row_begin + rows - 1);
    if (r0 > r1) continue;  // the sprite misses this tile
    const uint8_t value = static_cast<uint8_t>(k + 1);
    const int c0 = max(static_cast<int>(st[T_COL0]), 0);
    const int c1 = min(static_cast<int>(st[T_COL1]), w - 1);
    if (centroid)
      fill_sprite_centroid(st, V, value, r0, r1, c0, c1, row_begin, canvas,
                           w, wx, warp, kWarps, lane);
    else
      fill_sprite(st, V, value, r0, r1, c0, c1, row_begin, canvas, w, wx, ww,
                  warp, kWarps, lane);
  }
  __syncthreads();

  // Canvas row row_begin + y is image row h - 1 - (row_begin + y).
  uint8_t* img = out + size_t(scene) * h * w * 3;
  for (int i = tid; i < rows * w; i += kThreads) {
    const int y = i / w, x = i - y * w;
    slot_pixel(s_ctab[canvas[i]],
               img + (size_t(h - 1 - row_begin - y) * w + x) * 3);
  }
}

}  // namespace

// Shared memory a packed_raster block needs; the wrapper checks its Python
// mirror (rasterize_cuda.packed_smem_bytes) against the card's limit.
extern "C" long long packed_raster_smem_bytes(int K, int tile_rows, int w) {
  return static_cast<long long>(layout(K, tile_rows, w).bytes);
}

// The image at anti_aliasing=1 of B scenes of h x w pixels, in tiles of
// `tile_rows` rows; `centroid` selects the fill. Launches on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int packed_raster_launch(const float* tab, int B, int K, int V,
                                    int NT, int h, int w, int centroid,
                                    int tile_rows, int bg_packed,
                                    uint8_t* out, void* stream) {
  const Layout L = layout(K, tile_rows, w);
  cudaError_t err = cudaFuncSetAttribute(
      packed_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles = (h + tile_rows - 1) / tile_rows;
  packed_raster_kernel<<<B * num_tiles, kThreads, L.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      tab, K, V, NT, h, w, centroid, tile_rows, num_tiles, bg_packed, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
