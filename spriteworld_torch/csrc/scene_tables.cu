// The render's per-sprite scene tables for Hopper (sm_90a): factors in, the
// packed f32[B, K, table_width(V)] table out, in one launch.
//
// What it replaces. No pallas_call: the JAX package builds these tables in
// XLA (spriteworld_tpu/ops/rasterize_pallas.py `_prepare` and
// `_build_edge_tables`), which fuses the chain into a few kernels. The
// port's plain twin, `prepare_plain` in spriteworld_torch/ops/
// rasterize_cuda.py, runs it as ~230 small PyTorch kernels a call (vertices
// from the bank, rotated, scaled and truncated; HSV to RGB; Pillow's wedge
// intervals; a stable sort and a gather that compact the features; bounds;
// concatenations), each a launch of ~2 us on the card. This kernel computes
// the same table in one launch. The table layout is the raster kernels'
// (scene_raster, strip_raster, packed_raster): NUM_SCALARS scalars (vertex
// count, feature count, packed colour, global bottom row, pixel bounds),
// 5V edge fields, then 2V features (row, lo, hi). The exact fill
// (`exact` = 1) writes truncated edges and Pillow's horizontal-edge and
// wedge features compacted to the front; the centroid fill writes the
// untruncated edges and no features.
//
// What bounds it. At 2048 scenes of 2 sprites it reads 164 kB of factors
// and writes 5.5 MB of tables (338 floats a sprite): 1.7 us at 3.35 TB/s.
// Its arithmetic (two float64 sin/cos and ~100 float32 operations a
// vertex) is smaller still. At the sizes a step renders the launch itself
// is most of its time.
//
// Design. One warp a sprite, lane v holding vertex v (V <= 32; the bank
// has V = 30). The next vertex of an edge and the cyclic neighbours within
// three steps of Pillow's wedge test come from __shfl_sync; the global
// bottom row and the pixel bounds from warp reductions; the stable
// partition that compacts the active features (horizontal edges first,
// then wedges, each in vertex order, as the twin's stable sort leaves
// them) from __ballot_sync and a __popc prefix. The warp stages its row in
// shared memory and writes it out coalesced. Dead slots (slot >= the
// scene's sprite count) get count 0, as in the twin.
//
// Rounding. The twin runs one eager operator a step and each rounds once,
// so every float operation here is one IEEE operation with an explicit
// rounding (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never
// contracts into a fused multiply-add, in the twin's order: the angle as
// the float32 product angle * (float)(pi / 180), its sine and cosine in
// float64 rounded once to float32 (`geometry.centered_vertices`), the
// rotation as c*x - s*y and s*x + c*y, then the position and the canvas
// scale; HSV to RGB in `colors.hsv_to_rgb`'s order (sector floor(h*6)
// taken modulo 6 as torch's remainder), clamped to [0, 255] and truncated
// as the u8 cast; trunc, floor, ceil, Pillow's round-half-up floor(u +
// 0.5) and the 1e9 sentinels as the twin has them. Minima and maxima
// propagate NaN, as torch's do. So the table equals the twin's bit for
// bit (tests/test_torch_scene_tables.py; chip_smoke.py's `kernels` line).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVertices = 32;
constexpr int kScalars = 8, kEdgeFields = 5, kFeatureFields = 3;
constexpr int kRowMax =
    kScalars + (kEdgeFields + 2 * kFeatureFields) * kMaxVertices;
constexpr float kBig = 1e9f;
constexpr unsigned kAll = 0xFFFFFFFFu;
// Colour routes: the factors' c0..c2 as they are, HSV computed here, or
// colours a PyTorch colour map computed (u8-valued floats [B, K, 3]).
constexpr int kColorNone = 0, kColorHsv = 1, kColorGiven = 2;

__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = tmin(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = tmax(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

// torch's float -> u8 cast of a colour clamped to [0, 255], as a float.
__device__ __forceinline__ float u8(float c) {
  return truncf(tmin(tmax(c, 0.0f), 255.0f));
}

// colors.hsv_to_rgb of one colour, then the u8 cast.
__device__ __forceinline__ void hsv_rgb(float h, float s, float v,
                                        float& r, float& g, float& b) {
  const float h6 = __fmul_rn(h, 6.0f);
  const float i = floorf(h6);
  const float f = __fsub_rn(h6, i);
  long long sector = static_cast<long long>(i) % 6;
  if (sector < 0) sector += 6;
  const float p = __fmul_rn(v, __fsub_rn(1.0f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, f)));
  const float t =
      __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, __fsub_rn(1.0f, f))));
  // The channel tables of colorsys's six sectors.
  const int sec = static_cast<int>(sector);
  const float rr = sec == 0 || sec == 5 ? v : sec == 1 ? q : sec == 4 ? t : p;
  const float gg = sec == 1 || sec == 2 ? v : sec == 0 ? t : sec == 3 ? q : p;
  const float bb = sec == 3 || sec == 4 ? v : sec == 2 ? t : sec == 5 ? q : p;
  r = u8(__fmul_rn(255.0f, rr));
  g = u8(__fmul_rn(255.0f, gg));
  b = u8(__fmul_rn(255.0f, bb));
}

// Pillow's wedge interval ends: vx + (adj - vy) * (nx - vx) / d.
__device__ __forceinline__ float crossing(float vx, float vy, float adj,
                                          float nx, float ny) {
  const float d = ny == vy ? 1.0f : __fsub_rn(ny, vy);
  return __fadd_rn(vx, __fdiv_rn(__fmul_rn(__fsub_rn(adj, vy),
                                           __fsub_rn(nx, vx)), d));
}

// The nearest distinct cyclic neighbour of vertex v within three steps in
// `dir` (rasterize._cyclic_neighbor): steps wrap modulo n = max(count, 1).
__device__ __forceinline__ bool neighbour(float x0, float y0, int v, int n,
                                          int dir, float& nx, float& ny) {
  bool found = false;
  nx = 0.0f;
  ny = 0.0f;
#pragma unroll
  for (int step = 1; step <= 3; ++step) {
    int j = (v + dir * step) % n;
    if (j < 0) j += n;
    const float cx = __shfl_sync(kAll, x0, j);
    const float cy = __shfl_sync(kAll, y0, j);
    const bool differs = cx != x0 || cy != y0;
    if (!found && differs) {
      nx = cx;
      ny = cy;
    }
    found = found || differs;
  }
  return found;
}

__global__ void __launch_bounds__(kThreads)
scene_tables_kernel(const float* __restrict__ factors, long long fstride_b,
                    long long fstride_k, const int* __restrict__ num_sprites,
                    long long nstride, const float* __restrict__ bank,
                    const int* __restrict__ bank_counts, int num_shapes,
                    int batch, int k_max, int nv, float sx_canvas,
                    float sy_canvas, float deg2rad, int exact,
                    int color_mode, const float* __restrict__ colors,
                    float* __restrict__ out) {
  __shared__ float rows[kWarps][kRowMax];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sprite =
      static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (sprite >= static_cast<long long>(batch) * k_max) return;
  const int b = static_cast<int>(sprite / k_max);
  const int k = static_cast<int>(sprite - static_cast<long long>(b) * k_max);
  const float* f = factors + b * fstride_b + k * fstride_k;
  const int width = kScalars + (kEdgeFields + 2 * kFeatureFields) * nv;
  float* row = rows[warp];

  // The sprite's shape (torch's int64 cast, a negative id indexing from
  // the end) and live vertex count.
  int shape = static_cast<int>(static_cast<long long>(__ldg(f + 2)));
  if (shape < 0) shape += num_shapes;
  shape = min(max(shape, 0), num_shapes - 1);
  const bool live = k < __ldg(num_sprites + b * nstride);
  const int count = live ? __ldg(bank_counts + shape) : 0;

  // Canvas vertex v = lane (lanes >= nv repeat the last vertex and write
  // nothing), geometry.world_vertices times the canvas size.
  const bool in = lane < nv;
  const int v = in ? lane : nv - 1;
  const float scale = __ldg(f + 4);
  const float bx = __fmul_rn(__ldg(bank + (shape * nv + v) * 2), scale);
  const float by = __fmul_rn(__ldg(bank + (shape * nv + v) * 2 + 1), scale);
  const double rad = static_cast<double>(__fmul_rn(__ldg(f + 3), deg2rad));
  const float c = static_cast<float>(cos(rad));
  const float s = static_cast<float>(sin(rad));
  const float xc = __fmul_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(c, bx), __fmul_rn(s, by)), __ldg(f)),
      sx_canvas);
  const float yc = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(s, bx), __fmul_rn(c, by)), __ldg(f + 1)),
      sy_canvas);

  // Edge v runs from vertex v to vertex (v + 1) mod nv.
  const float x0 = exact ? truncf(xc) : xc;
  const float y0 = exact ? truncf(yc) : yc;
  const int next = v + 1 == nv ? 0 : v + 1;
  const float x1 = __shfl_sync(kAll, x0, next);
  const float y1 = __shfl_sync(kAll, y0, next);
  const bool valid = in && v < count;
  const float ymin_e = tmin(y0, y1);
  const float ymax_e = tmax(y0, y1);
  const float gymax = warp_max(valid ? ymax_e : -kBig);
  const float dy = y1 == y0 ? 1.0f : __fsub_rn(y1, y0);

  const int feat0 = kScalars + kEdgeFields * nv;
  for (int i = lane; i < 2 * kFeatureFields * nv; i += 32) row[feat0 + i] = 0;
  __syncwarp();

  float e3, e4, e1;
  int nf = 0;
  if (exact) {
    const bool horiz = valid && y0 == y1;
    const bool slant = valid && y0 != y1;
    e1 = __fdiv_rn(__fsub_rn(x1, x0), dy);
    e3 = slant ? ymin_e : kBig;
    e4 = slant ? ymax_e : -kBig;

    // Pillow's wedges (rasterize.wedge_intervals).
    const int n = max(count, 1);
    float px, py, nx, ny;
    const bool pf = neighbour(x0, y0, v, n, -1, px, py);
    const bool nfound = neighbour(x0, y0, v, n, +1, nx, ny);
    const bool ok = valid && pf && nfound && py != y0 && ny != y0;
    const bool is_top = ok && py > y0 && ny > y0;
    const bool is_gbot = ok && py < y0 && ny < y0 && y0 == gymax;
    const float adj = is_top ? __fadd_rn(y0, 1.0f) : __fsub_rn(y0, 1.0f);
    const float u1 = crossing(x0, y0, adj, px, py);
    const float u2 = crossing(x0, y0, adj, nx, ny);
    const bool active = is_top || is_gbot;
    const bool right = active && u1 > x0 && u2 > x0;
    const bool left = active && u1 < x0 && u2 < x0;
    const float lo = right ? x0
                     : left ? __fadd_rn(floorf(__fadd_rn(tmax(u1, u2), 0.5f)),
                                        1.0f)
                            : kBig;
    const float hi = right ? __fsub_rn(floorf(__fadd_rn(tmin(u1, u2), 0.5f)),
                                       1.0f)
                     : left ? x0
                            : -kBig;
    const bool wedge = right || left;

    // The stable partition: active horizontal edges, then active wedges,
    // each in vertex order.
    const unsigned hmask = __ballot_sync(kAll, horiz);
    const unsigned wmask = __ballot_sync(kAll, wedge);
    const unsigned below = (1u << lane) - 1u;
    const int nh = __popc(hmask);
    nf = nh + __popc(wmask);
    if (horiz) {
      float* o = row + feat0 + kFeatureFields * __popc(hmask & below);
      o[0] = y0;
      o[1] = tmin(x0, x1);
      o[2] = tmax(x0, x1);
    }
    if (wedge) {
      float* o = row + feat0 + kFeatureFields * (nh + __popc(wmask & below));
      o[0] = y0;
      o[1] = lo;
      o[2] = hi;
    }
  } else {
    // points_in_polygons' edges: its dy guard, y1 (y0 on invalid edges)
    // and x1 - x0.
    e1 = dy;
    e3 = valid ? y1 : y0;
    e4 = __fsub_rn(x1, x0);
  }
  if (in) {
    row[kScalars + v] = y0;
    row[kScalars + nv + v] = e1;
    row[kScalars + 2 * nv + v] = x0;
    row[kScalars + 3 * nv + v] = e3;
    row[kScalars + 4 * nv + v] = e4;
  }

  // Pixel bounds from the untruncated extent of the live vertices.
  const float ymin = warp_min(valid ? yc : kBig);
  const float ymax = warp_max(valid ? yc : -kBig);
  const float xmin = warp_min(valid ? xc : kBig);
  const float xmax = warp_max(valid ? xc : -kBig);
  if (lane == 0) {
    float r, g, bl;
    if (color_mode == kColorHsv) {
      hsv_rgb(__ldg(f + 5), __ldg(f + 6), __ldg(f + 7), r, g, bl);
    } else if (color_mode == kColorGiven) {
      const float* cc = colors + sprite * 3;
      r = __ldg(cc);
      g = __ldg(cc + 1);
      bl = __ldg(cc + 2);
    } else {
      r = u8(__ldg(f + 5));
      g = u8(__ldg(f + 6));
      bl = u8(__ldg(f + 7));
    }
    row[0] = static_cast<float>(count);
    row[1] = static_cast<float>(nf);
    row[2] = __fadd_rn(__fadd_rn(__fmul_rn(r, 65536.0f), __fmul_rn(g, 256.0f)),
                       bl);
    row[3] = gymax;
    row[4] = __fsub_rn(floorf(ymin), 1.0f);
    row[5] = __fadd_rn(ceilf(ymax), 1.0f);
    row[6] = __fsub_rn(floorf(xmin), 2.0f);
    row[7] = __fadd_rn(ceilf(xmax), 2.0f);
  }
  __syncwarp();
  float* dst = out + sprite * width;
  for (int i = lane; i < width; i += 32) dst[i] = row[i];
}

}  // namespace

// The tables of `batch` scenes of `k_max` sprite slots: factors f32[.., 10]
// (scene b's slot k at factors + b * fstride_b + k * fstride_k, columns
// contiguous), num_sprites i32 (scene b's at b * nstride), the vertex bank
// f32[num_shapes, nv, 2] and its vertex counts i32[num_shapes]; canvas
// scale (wc, hc); exact = 1 for the exact fill, 0 for the centroid fill;
// colours by `color_mode` (colors: u8-valued f32[batch, k_max, 3] for the
// given route, else unused). Writes out f32[batch, k_max, 8 + 11 nv] on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int scene_tables_launch(
    const float* factors, long long fstride_b, long long fstride_k,
    const int* num_sprites, long long nstride, const float* bank,
    const int* bank_counts, int num_shapes, int batch, int k_max, int nv,
    float sx_canvas, float sy_canvas, float deg2rad, int exact,
    int color_mode, const float* colors, float* out, void* stream) {
  if (batch <= 0 || k_max <= 0) return 0;
  if (nv <= 0 || nv > kMaxVertices || num_shapes <= 0 ||
      color_mode < kColorNone || color_mode > kColorGiven ||
      (color_mode == kColorGiven && colors == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sprites = static_cast<long long>(batch) * k_max;
  const long long blocks = (sprites + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  scene_tables_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      factors, fstride_b, fstride_k, num_sprites, nstride, bank, bank_counts,
      num_shapes, batch, k_max, nv, sx_canvas, sy_canvas, deg2rad, exact,
      color_mode, colors, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
