"""Rasterizer for the card: three hand-written CUDA kernels and their plain
twin.

Counterpart of `spriteworld_tpu/ops/rasterize_pallas.py`'s scene kernel
(`_fill_kernel_scene`), its `_fill_kernel` in row-strip and packed mode, and
their host preparation (`_prepare`, `_build_edge_tables`). Same contract as
`ops/rasterize.py`: paint sprite polygons back-to-front on an
`anti_aliasing`-supersampled canvas with Pillow's exact scanline fill
(`pil_exact=True`) or the even-odd test at pixel centres (`pil_exact=False`),
downsample with Pillow's Lanczos filter, the box filter or not at all
(anti_aliasing=1), flip to math coordinates.

The work splits in five:

* `prepare` turns factors into one packed per-sprite table: scalars
  (vertex count, feature count, packed colour, global bottom row, pixel
  bounds), then five per-edge fields. For the exact fill those are the
  scanline fill's fields of the truncated vertices, followed by Pillow's
  horizontal-edge and wedge features compacted to (row, lo, hi) integer
  intervals; for the centroid fill they are the untruncated edges as
  `points_in_polygons` reads them, and there are no features. On a CUDA
  tensor it is one launch of `csrc/scene_tables.cu` (`scene_tables`); on a
  CPU tensor its plain twin `prepare_plain` runs, plain elementwise torch
  operations that nothing fuses into an FMA, and the kernel rounds at the
  same places.
* `scene_raster` launches the scene kernel (`csrc/scene_raster.cu`) on a
  CUDA table: one thread block renders one whole scene, its canvas in
  shared memory.
* `strip_raster` and `strip_vpass` launch the row-strip kernels
  (`csrc/strip_raster.cu`): one block fills one strip of canvas rows and
  runs the horizontal Lanczos pass (or the box filter, whole); a second
  kernel runs the vertical Lanczos pass. They take the canvases whose scene
  layout does not fit one block's shared memory (`render_rgb_batch`'s
  `kernel_mode="auto"`).
* `packed_raster` launches the anti_aliasing=1 kernel for small canvases
  (`csrc/packed_raster.cu`), where the JAX package takes its packed mode
  (`uses_packed`).
* `lanczos_tiles` builds, in numpy and cached by size, the banded tap tiles
  the scene and strip kernels' Lanczos passes multiply on the int8 tensor
  cores (`csrc/lanczos_mma.cuh`): each tap split into u8/u8/s8 limbs, laid
  out as mma.sync fragments.
* `render_rgb_batch_plain` computes the same function from the same table
  with torch operations. CPU tensors take it; on the card every kernel is
  held against it, bit for bit (`hpass_plain` and `vpass_plain` are its two
  Lanczos passes, for holding the strip kernels against it one at a time).
  `box_words` repeats the kernels' box filter by words in torch (the
  one-slot test and the masked sums): the CPU tests hold it against the
  box filter, and chip_smoke.py counts the kernels' work with it.

All evaluate the exact fill's crossing as the float32 multiply-then-add
``x0 + (row - y0) * m`` and the centroid fill's as ``x0 + ((py - y0) / dy)
* dx``, each operation rounded once; all downsample with Pillow's integer
Lanczos taps, or with the box filter's integer sums divided once and
rounded half to even (the kernels' limb products are exact int32 sums of
the same integers). So the kernels and the plain version agree on every
value, and agree with Pillow and with `ops/rasterize.py`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from spriteworld_torch import constants
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import _build
from spriteworld_torch.ops import geometry
from spriteworld_torch.ops import rasterize
from spriteworld_torch.ops import resample
from spriteworld_torch.utils import colors as color_maps
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling

_BIG = 1e9

# Scalar fields at the head of each sprite's table row.
(T_COUNT, T_NF, T_COLOR, T_GYMAX,
 T_ROW0, T_ROW1, T_COL0, T_COL1) = range(8)
NUM_SCALARS = 8
# Per-edge fields that follow, each a block of V values: the exact fill's,
E_Y0, E_M, E_X0, E_YMIN, E_YMAX = range(5)
# or, in the same places, the centroid fill's (edge e runs from (x0, y0) to
# (x0 + dx, y1); dy = y1 - y0, or 1 where that is 0).
C_Y0, C_DY, C_X0, C_Y1, C_DX = range(5)
NUM_EDGE_FIELDS = 5
# Then 2V compacted features (row, lo, hi).
NUM_FEATURE_FIELDS = 3


def table_width(num_vertices: int) -> int:
    """Floats per sprite in the packed table."""
    return (NUM_SCALARS + NUM_EDGE_FIELDS * num_vertices
            + NUM_FEATURE_FIELDS * 2 * num_vertices)


@dataclasses.dataclass
class SceneTables:
    """Packed per-sprite tables of a batch of scenes.

    tab: f32[B, K, table_width(V)]. In the exact fill's tables every value
    is an exact integer except the edge slopes `m`; colours are packed as
    r*65536 + g*256 + b. `pil_exact` says which fill the tables are for.
    """

    tab: torch.Tensor
    num_vertices: int
    hc: int
    wc: int
    pil_exact: bool = True

    def features(self):
        """f32[B, K, 2V, 3] of (row, lo, hi); the first `nf` are active."""
        v = self.num_vertices
        start = NUM_SCALARS + NUM_EDGE_FIELDS * v
        return self.tab[..., start:].reshape(self.tab.shape[:-1] + (2 * v, 3))


def prepare(factors: torch.Tensor, num_sprites: torch.Tensor, hc: int,
            wc: int, color_to_rgb, pil_exact: bool = True) -> SceneTables:
    """Per-scene tables of factors[B, K, 10] for the exact fill, or with
    pil_exact=False for the centroid fill; `color_to_rgb` is None, "hsv"
    or a colour map (`color_route`). CUDA factors launch the kernel
    (`scene_tables`), CPU factors take the plain twin (`prepare_plain`)."""
    fn = scene_tables if factors.is_cuda else prepare_plain
    return fn(factors, num_sprites, hc, wc, color_to_rgb, pil_exact)


# How the tables take a colour map: the factors' c0..c2 as they are, HSV
# computed from them, or colours a PyTorch colour map computed first.
COLOR_ROUTES = ("none", "hsv", "given")


def color_route(color_to_rgb) -> str:
    """"none" for None, "hsv" for "hsv" or `utils.colors.hsv_to_rgb`,
    "given" for any other callable; raises on anything else."""
    if color_to_rgb is None:
        return "none"
    if color_to_rgb is color_maps.hsv_to_rgb or (
            isinstance(color_to_rgb, str) and color_to_rgb == "hsv"):
        return "hsv"
    if callable(color_to_rgb):
        return "given"
    raise ValueError(f"Unknown color_to_rgb: {color_to_rgb!r}")


def tables_mode(pil_exact: bool, color_to_rgb) -> str:
    """"<fill>+<colour route>", e.g. "exact+hsv": the key of
    `scene_tables.by_mode`."""
    return ("exact" if pil_exact else "centroid") + "+" + color_route(
        color_to_rgb)


def prepare_plain(factors: torch.Tensor, num_sprites: torch.Tensor, hc: int,
                  wc: int, color_to_rgb,
                  pil_exact: bool = True) -> SceneTables:
    """The plain torch twin of `scene_tables` (same arguments, same table),
    on any device: one eager operator a step, each rounded once."""
    if color_route(color_to_rgb) == "hsv":
        color_to_rgb = color_maps.hsv_to_rgb
    dev = factors.device
    verts_c = rasterize._canvas_vertices(factors, hc, wc)  # [B, K, V, 2]
    b, k, vmax, _ = verts_c.shape
    shape_ids = factors[..., state_lib.SHAPE].to(torch.int64)
    live = torch.arange(k, device=dev) < num_sprites[:, None]
    # Dead slots get count 0: their edges turn neutral and the kernel
    # skips them without a separate liveness flag.
    counts = torch.where(
        live, device_lib.constant(constants.VERTEX_COUNTS, dev)[shape_ids], 0)

    colors = rasterize.sprite_colors(factors, color_to_rgb)
    packed = colors[..., 0] * 65536.0 + colors[..., 1] * 256.0 + colors[..., 2]

    v = torch.trunc(verts_c) if pil_exact else verts_c
    x0, y0 = v[..., 0], v[..., 1]
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    valid = torch.arange(vmax, device=dev) < counts[..., None]
    big = torch.full_like(y0, _BIG)
    ymin_e = torch.minimum(y0, y1)
    ymax_e = torch.maximum(y0, y1)
    gymax = torch.where(valid, ymax_e, -big).amax(-1)  # [B, K]
    dy = torch.where(y1 == y0, torch.ones_like(y1), y1 - y0)

    if pil_exact:
        horiz = (y0 == y1) & valid
        slant = (y0 != y1) & valid
        m = (x1 - x0) / dy
        # Features: horizontal edges fill [min x, max x] on their row;
        # wedges fill [lo, hi] on their vertex row. Active ones are
        # compacted to the front (a stable partition), the rest zeroed.
        wact, wlo, whi = rasterize.wedge_intervals(x0, y0, valid, counts,
                                                   gymax)
        act = torch.cat([horiz, wact], -1)  # [B, K, 2V]
        cand = torch.stack([
            torch.cat([y0, y0], -1),
            torch.cat([torch.minimum(x0, x1), wlo], -1),
            torch.cat([torch.maximum(x0, x1), whi], -1)], -1)  # [B, K, 2V, 3]
        order = torch.sort((~act).to(torch.int8), dim=-1, stable=True).indices
        feats = cand.gather(-2, order[..., None].expand(-1, -1, -1, 3))
        nf = act.sum(-1)
        keep = torch.arange(2 * vmax, device=dev) < nf[..., None]
        feats = torch.where(keep[..., None], feats, torch.zeros_like(feats))
        edges = torch.cat([
            y0, m, x0,
            torch.where(slant, ymin_e, big),
            torch.where(slant, ymax_e, -big)], -1)  # [B, K, 5V]
    else:
        # points_in_polygons' edges, its dy guard and its x2 - x1; invalid
        # edges get y1 := y0, so they never straddle a row (as JAX's
        # _build_edge_tables does).
        feats = torch.zeros((b, k, 2 * vmax, 3), device=dev)
        nf = torch.zeros_like(counts)
        edges = torch.cat([y0, dy, x0, torch.where(valid, y1, y0), x1 - x0],
                          -1)

    # Conservative pixel bounds from the untruncated extent: wedges reach
    # round_half_up(u) +- 1 of an edge intersection inside the vertex
    # x-extent; pair, window and centroid fills reach at most the extent
    # + 0.5.
    xs, ys = verts_c[..., 0], verts_c[..., 1]
    bigv = torch.full_like(ys, _BIG)
    ymin = torch.where(valid, ys, bigv).amin(-1)
    ymax = torch.where(valid, ys, -bigv).amax(-1)
    xmin = torch.where(valid, xs, bigv).amin(-1)
    xmax = torch.where(valid, xs, -bigv).amax(-1)

    scal = torch.stack([
        counts.to(torch.float32), nf.to(torch.float32), packed, gymax,
        torch.floor(ymin) - 1.0, torch.ceil(ymax) + 1.0,
        torch.floor(xmin) - 2.0, torch.ceil(xmax) + 2.0], -1)
    tab = torch.cat([scal, edges, feats.reshape(b, k, 6 * vmax)], -1)
    return SceneTables(tab=tab.contiguous(), num_vertices=vmax, hc=hc, wc=wc,
                       pil_exact=bool(pil_exact))


@functools.lru_cache(maxsize=None)
def _tables_launcher():
    """(library, its C launch function with argument types declared)."""
    lib = _build.load("scene_tables")
    fn = lib.scene_tables_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib, fn


_DEG2RAD_F32 = float(np.float32(geometry._DEG2RAD))


def scene_tables(factors: torch.Tensor, num_sprites: torch.Tensor, hc: int,
                 wc: int, color_to_rgb,
                 pil_exact: bool = True) -> SceneTables:
    """One launch of `csrc/scene_tables.cu` over CUDA factors f32[B, K, 10]
    (columns contiguous) and num_sprites [B]: the table `prepare_plain`
    computes, bit for bit. The "none" and "hsv" colour routes are computed
    in the kernel; a "given" colour map runs in PyTorch first and the
    kernel reads its colours. Runs on the current stream; raises where the
    kernel cannot take the input or cannot launch. Each launch adds one to
    `scene_tables.launches`, `.by_mode[tables_mode(...)]` and
    `.by_batch[B]`, and to the census of a graph being captured."""
    if not factors.is_cuda:
        raise ValueError("scene_tables needs CUDA factors; CPU tensors use "
                         "prepare_plain")
    if factors.dtype != torch.float32 or factors.dim() != 3 \
            or factors.shape[-1] != state_lib.NUM_FACTORS:
        raise ValueError(f"scene_tables takes factors f32[B, K, "
                         f"{state_lib.NUM_FACTORS}], got "
                         f"{tuple(factors.shape)} {factors.dtype}")
    b, k, _ = factors.shape
    if num_sprites.shape != (b,) or num_sprites.device != factors.device:
        raise ValueError(f"num_sprites must be [{b}] on {factors.device}, "
                         f"got {tuple(num_sprites.shape)} on "
                         f"{num_sprites.device}")
    dev = factors.device
    bank = geometry.vertex_bank(dev)
    counts = device_lib.constant(constants.VERTEX_COUNTS, dev)
    shapes, v, _ = bank.shape
    if v > 32:
        raise ValueError(f"scene_tables takes V <= 32 (V={v})")
    route = color_route(color_to_rgb)
    given = (rasterize.sprite_colors(factors, color_to_rgb).contiguous()
             if route == "given" else None)
    if factors.stride(-1) != 1:
        factors = factors.contiguous()
    num = num_sprites.to(torch.int32)
    tab = torch.empty((b, k, table_width(v)), dtype=torch.float32,
                      device=dev)
    tables = SceneTables(tab=tab, num_vertices=v, hc=hc, wc=wc,
                         pil_exact=bool(pil_exact))
    if b * k == 0:
        return tables
    lib, launch = _tables_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(factors.data_ptr(), factors.stride(0), factors.stride(1),
                     num.data_ptr(), num.stride(0), bank.data_ptr(),
                     counts.data_ptr(), shapes, b, k, v, float(wc), float(hc),
                     _DEG2RAD_F32, int(bool(pil_exact)),
                     COLOR_ROUTES.index(route), _ptr(given), tab.data_ptr(),
                     stream)
    _check_launch(lib, err, "scene_tables")
    _count_launch(scene_tables, tables_mode(pil_exact, color_to_rgb), b)
    return tables


# The tensor-core Lanczos passes (csrc/lanczos_mma.cuh): m-tiles of 16
# outputs, K steps of 32 inputs, three limbs a tap.
MMA_M, MMA_K = 16, 32
LIMB_SHIFTS = (0, 8, 16)


@dataclasses.dataclass(frozen=True)
class LanczosTiles:
    """One Lanczos pass (in_size -> out_size) as banded integer tiles.

    M-tile m holds outputs 16m .. 16m + 15 (past out_size: zero taps) and
    reads the inputs [kstart[m], kstart[m] + 32 * ksteps), kstart a
    multiple of 16, every nonzero tap inside; the rest are zero taps. The
    pass's input rows have `pitch` bytes (>= in_size, and >= every window's
    end; an odd multiple of 16, so a warp's eight rows of a fragment load
    fall in distinct shared-memory banks).

    limbs: i64[mt, 3, 16, 32 * ksteps], q = limbs[0] + limbs[1] * 2^8 +
    limbs[2] * 2^16 with limbs 0 and 1 in [0, 255] and limb 2 in
    [-128, 127]. frags: the same bytes as the kernels' mma.sync A fragments,
    i32[mt, ksteps, 3, 32 lanes, 4] (lane = 4 * group + t holds rows group
    and group + 8, inputs 4t..4t+3 and 16+4t..16+4t+3 of the K step).
    qsum: i32[16 * mt], each output's sum of taps (a window of one colour c
    sums to c * qsum).
    """

    kstart: np.ndarray
    ksteps: int
    pitch: int
    limbs: np.ndarray
    frags: np.ndarray
    qsum: np.ndarray


def _pitch(in_size: int, window: int) -> int:
    p = max(_round16(in_size), window)
    return p if (p // 16) % 2 else p + 16


@functools.lru_cache(maxsize=None)
def lanczos_tiles(in_size: int, out_size: int) -> LanczosTiles:
    """The tiles of Pillow's Lanczos pass in_size -> out_size (a function of
    the sizes alone, cached)."""
    xmins, taps = resample.pil_lanczos_fixed(in_size, out_size)
    ends = xmins + np.array([len(t) for t in taps])
    mt = -(-out_size // MMA_M)
    first = np.array([xmins[MMA_M * m:MMA_M * (m + 1)].min()
                      for m in range(mt)])
    last = np.array([ends[MMA_M * m:MMA_M * (m + 1)].max()
                     for m in range(mt)])
    kstart = first // 16 * 16
    ksteps = int((-(-(last - kstart) // MMA_K)).max())
    window = MMA_K * ksteps
    pitch = _pitch(in_size, window)
    # Windows past the pitch start earlier (still multiples of 16): every
    # tap ends by in_size <= pitch.
    kstart = np.minimum(kstart, pitch - window).astype(np.int32)
    q = np.zeros((mt * MMA_M, window), np.int64)
    for o, (xmin, t) in enumerate(zip(xmins, taps)):
        off = xmin - kstart[o // MMA_M]
        q[o, off:off + len(t)] = t
    # The kernels' sum 2^21 + sum(q * p), p <= 255, must fit int32, as
    # Pillow's does.
    if np.abs(q).sum(1).max() * 255 + (1 << 21) >= 1 << 31:
        raise ValueError("Lanczos taps overflow an int32 accumulator")
    limbs = np.stack([q & 255, (q >> 8) & 255, q >> 16], 1).reshape(
        mt, MMA_M, 3, window).transpose(0, 2, 1, 3)
    if limbs[:, 2].min() < -128 or limbs[:, 2].max() > 127:
        raise ValueError("a Lanczos tap's high limb exceeds int8")
    # A fragment register r of lane (group, t): row group + 8 * (r & 1),
    # inputs 16 * (r >> 1) + 4t + (0..3), little-endian.
    lane = np.arange(32)
    r = np.arange(4)
    rows = (lane >> 2)[:, None] + 8 * (r & 1)[None, :]
    cols = 16 * (r >> 1)[None, :] + 4 * (lane & 3)[:, None]
    u8 = (limbs & 255).astype(np.uint8).reshape(mt, 3, MMA_M, ksteps, MMA_K)
    u8 = u8.transpose(0, 3, 1, 2, 4)  # [mt, ks, 3, 16, 32]
    frag_bytes = u8[..., rows[..., None], cols[..., None] + np.arange(4)]
    frags = np.ascontiguousarray(frag_bytes).view("<i4")[..., 0]
    return LanczosTiles(kstart=kstart, ksteps=ksteps, pitch=pitch,
                        limbs=limbs, frags=np.ascontiguousarray(frags),
                        qsum=q.sum(1).astype(np.int32))


@functools.lru_cache(maxsize=None)
def lanczos_tiles_on(in_size: int, out_size: int, device: torch.device):
    """(tiles, then its frags, kstart and qsum as i32 tensors on
    `device`), cached by sizes and device."""
    t = lanczos_tiles(in_size, out_size)
    return (t,) + tuple(torch.from_numpy(a).to(device)
                        for a in (t.frags, t.kstart, t.qsum))


# Downsample modes of the kernels (csrc/raster_fill.cuh DS_*).
DS_IDENTITY, DS_LANCZOS, DS_BOX = 0, 1, 2
DOWNSAMPLES = ("auto", "lanczos", "box")


def downsample_mode(anti_aliasing: int, pil_exact: bool,
                    downsample: str) -> int:
    """DS_IDENTITY at anti_aliasing=1 whatever `downsample` says, else
    DS_LANCZOS or DS_BOX; "auto" follows the fill (Lanczos with the exact
    fill, box with the centroid fill), as `ops.rasterize.render_rgb_batch`."""
    if downsample not in DOWNSAMPLES:
        raise ValueError(f"Unknown downsample: {downsample!r}")
    if anti_aliasing == 1:
        return DS_IDENTITY
    if downsample == "auto":
        downsample = "lanczos" if pil_exact else "box"
    return DS_LANCZOS if downsample == "lanczos" else DS_BOX


def mode_name(pil_exact: bool, ds: int) -> str:
    """"<fill>+<downsample>", e.g. "centroid+box": the key of a kernel
    wrapper's `by_mode` launch counts."""
    return (("exact" if pil_exact else "centroid") + "+"
            + ("identity", "lanczos", "box")[ds])


def _count_launch(fn, mode: str, batch: int):
    """One more launch of kernel wrapper `fn` over `batch` scenes, in all,
    in `mode`, in `by_batch` and in the census of a graph being captured
    (`utils.profiling.count`)."""
    fn.launches += 1
    fn.by_mode[mode] = fn.by_mode.get(mode, 0) + 1
    fn.by_batch[batch] = fn.by_batch.get(batch, 0) + 1
    profiling.count(fn.__name__, mode)


def reset_launch_counts():
    """Set every kernel wrapper's launch counts to 0."""
    for fn in (scene_tables, scene_raster, strip_raster, strip_vpass,
               packed_raster):
        fn.launches = 0
        fn.by_mode = {}
        fn.by_batch = {}


def _round16(n: int) -> int:
    return (n + 15) & ~15


_SCENE_WARPS = 16  # scene_raster.cu threads_of(false) / 32
_SCENE_LANCZOS_WARPS = 8  # threads_of(true) / 32
_SCENE_BAND_ROWS = 80  # scene_raster.cu kBandRows
_STRIP_WARPS = 8  # strip_raster.cu kThreads / 32


def _round8(n: int) -> int:
    return (n + 7) & ~7


def _chan_bytes(k: int) -> int:
    """The kernels' per-block channel tables: 3 x (K + 1 rounded up to
    16) bytes (csrc/lanczos_mma.cuh chan_stride)."""
    return _round16(3 * _round16(k + 1))


def hpass_geometry(hc: int, h: int, w: int) -> Tuple[int, int]:
    """(rows wp, pitch hp) of a Lanczos render's h-pass buffer
    hpT[3][wp][hp]: output column x's canvas rows at bytes 0..hc-1 of row
    x, w rounded up to whole m-tiles, at the v-pass tiles' pitch. (The
    canvas rows have the h-pass tiles' pitch.)"""
    return MMA_M * -(-w // MMA_M), lanczos_tiles(hc, h).pitch


def scene_smem_bytes(k: int, num_vertices: int, hc: int, wc: int, h: int,
                     w: int, ds: int) -> int:
    """Shared memory of one scene_raster block in downsample mode `ds`: a
    mirror of `layout` in csrc/scene_raster.cu (chip_smoke.py holds the two
    equal). With the Lanczos filter the canvas holds one band of rows at
    the h-pass tiles' pitch, and the channel tables and the h-pass buffer
    follow. The box mode holds one group of anti_aliasing rows for each of
    the block's warps, the identity (anti_aliasing=1) the whole canvas, in
    rows of wc rounded up to 16 bytes, and the channel tables follow."""
    warps = _SCENE_LANCZOS_WARPS if ds == DS_LANCZOS else _SCENE_WARPS
    words = k * table_width(num_vertices) + k + 1 + 2 * warps * 32
    head = _round16(words * 4)
    if ds != DS_LANCZOS:
        rows = hc if ds == DS_IDENTITY else warps * (hc // h)
        return head + _round16(rows * _round16(wc)) + _chan_bytes(k)
    cp = lanczos_tiles(wc, w).pitch
    wp, hp = hpass_geometry(hc, h, w)
    band = min(_round8(hc), _SCENE_BAND_ROWS)
    return (head + _round16(band * cp) + _chan_bytes(k)
            + _round16(3 * wp * hp))


def strip_smem_bytes(k: int, strip_rows: int, wc: int,
                     w: Optional[int] = None) -> int:
    """Shared memory of one strip_raster block: a mirror of `layout` in
    csrc/strip_raster.cu, `strip_rows` canvas rows of wc rounded up to 16
    bytes, then the channel tables. With the Lanczos filter pass the output
    width `w`: the canvas then has round8(strip_rows) rows at the h-pass
    tiles' pitch."""
    head = _round16((k + 1 + 2 * _STRIP_WARPS * 32) * 4)
    if w is None:
        canvas = strip_rows * _round16(wc)
    else:
        canvas = _round8(strip_rows) * lanczos_tiles(wc, w).pitch
    return head + _round16(canvas) + _chan_bytes(k)


# csrc/packed_raster.cu: warps a block at most (a lane a row, so 32 times
# this is the most rows a tile), words of staged records a block holds at
# most (more go in chunks), words of a warp's output buffer (16 rows of
# 3 * 64 + 16 bytes).
_PACKED_MAX_WARPS = 4
_PACKED_STAGE_WORDS = 2560
_PACKED_OUT_WORDS = 16 * (3 * 64 + 16) // 4


def packed_threads(tile_rows: int) -> int:
    """Threads of a packed_raster block of `tile_rows` canvas rows: a warp
    for each 32 rows, up to four (csrc/packed_raster.cu `threads_of`)."""
    return 32 * min(_PACKED_MAX_WARPS, -(-tile_rows // 32))


def packed_record_words(count: int, nf: int) -> int:
    """Words of one sprite's record in packed_raster's shared memory
    (csrc/packed_raster.cu `record_words`): `count` float4 edges, their
    float2 row ranges (rounded up to 4 words), `nf` int4 features."""
    return 4 * count + ((2 * count + 3) & ~3) + 4 * nf


def packed_smem_bytes(k: int, num_vertices: int, tile_rows: int) -> int:
    """Shared memory of one packed_raster block: a mirror of `layout` in
    csrc/packed_raster.cu. The colour words (K + 1), the staging plan (an
    8-word header and 5 ints a sprite, 3 more), then the records' region:
    every
    sprite's record at its largest up to `_PACKED_STAGE_WORDS` words
    (larger tables are staged in chunks), and at least the warps' output
    buffers, which reuse it."""
    threads = packed_threads(tile_rows)
    most = min(k * packed_record_words(num_vertices, 2 * num_vertices),
               _PACKED_STAGE_WORDS)
    stage = max(most, threads // 32 * _PACKED_OUT_WORDS)
    return (_round16(4 * (k + 1)) + _round16((13 * k + 3) * 4)
            + 4 * stage)


KERNEL_MODES = ("auto", "scene", "strips")


def resolve_kernel_mode(kernel_mode: str, scene_bytes: int,
                        budget: int) -> str:
    """"scene" or "strips" for a batch whose scene layout takes
    `scene_bytes` of shared memory, on a card that gives a block `budget`.

    "auto" takes the scene kernel when its layout fits and the strips
    otherwise; an explicit "scene" that does not fit raises ValueError.
    """
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"Unknown kernel_mode: {kernel_mode!r}")
    if kernel_mode == "auto":
        return "scene" if scene_bytes <= budget else "strips"
    if kernel_mode == "scene" and scene_bytes > budget:
        raise ValueError(
            f"kernel_mode='scene' needs {scene_bytes} bytes of shared memory "
            f"a block and the card gives {budget}; use kernel_mode='strips' "
            "or 'auto' for this canvas.")
    return kernel_mode


def _num_strips(h: int, aa: int, wc: int, limit: int = 16000) -> int:
    """The JAX package's strip count (rasterize_pallas._pick_strip): whole
    output rows per program of ~`limit` canvas pixels."""
    if h % 8:
        return 1
    strip_out = next((c for c in (64, 32, 16)
                      if h % c == 0 and c * aa * wc <= limit), 8)
    if h * aa * wc <= limit:
        strip_out = h
    return h // strip_out


def uses_packed(image_size: Tuple[int, int], anti_aliasing: int,
                kernel_mode: str) -> bool:
    """Whether a render takes the anti_aliasing=1 small-canvas kernel: the
    JAX package's rule for its packed mode (render_rgb_batch), one strip at
    anti_aliasing=1 of a canvas narrower than 128 that divides 128 and
    fills whole 128-pixel rows, unless the caller asks for the scene
    kernel. Any other anti_aliasing=1 render takes the scene or strip
    kernels, as there."""
    h, w = image_size
    aa = int(anti_aliasing)
    hc, wc = h * aa, w * aa
    return (aa == 1 and _num_strips(h, aa, wc) == 1 and wc < 128
            and 128 % wc == 0 and (hc * wc) % 128 == 0
            and kernel_mode != "scene")


# Canvas bytes a strip block keeps in shared memory by default: small
# enough for three blocks on one SM.
_STRIP_CANVAS_BYTES = 64 * 1024


def default_strip_rows(hc: int, wc: int, multiple: int = 1) -> int:
    """Canvas rows per strip of `wc` bytes: as many as fit
    `_STRIP_CANVAS_BYTES`, rounded down to a multiple of `multiple` (the
    box filter's anti_aliasing, or the Lanczos h-pass's 8-row tiles), and
    at least `multiple`."""
    rows = min(hc, _STRIP_CANVAS_BYTES // wc) // multiple * multiple
    return max(multiple, rows)


def default_tile_rows(h: int) -> int:
    """Image rows per packed_raster block: the whole frame up to 128 rows,
    a lane a row (64x64: two warps); taller frames go in tiles of 128."""
    return max(1, min(h, 32 * _PACKED_MAX_WARPS))


def render_rgb_batch(factors: torch.Tensor,
                     num_sprites: torch.Tensor,
                     *,
                     image_size: Tuple[int, int] = (64, 64),
                     anti_aliasing: int = 1,
                     bg_color: Optional[Tuple[int, int, int]] = None,
                     color_to_rgb: Optional[Callable] = None,
                     pil_exact: bool = True,
                     downsample: str = "auto",
                     kernel_mode: str = "auto") -> torch.Tensor:
    """Render factors[B, K, 10] to u8[B, H, W, 3] (math orientation), in
    every mode of `ops.rasterize.render_rgb_batch` (same arguments).

    CUDA tensors launch a kernel: the anti_aliasing=1 small-canvas kernel
    where `uses_packed` says so; else the scene kernel when `kernel_mode`
    resolves to "scene" (see `resolve_kernel_mode`; "auto" decides from the
    card's shared memory per block before launching), the row-strip kernels
    otherwise. A kernel that cannot run raises; nothing falls back. CPU
    tensors take the plain version, whatever the mode.
    """
    aa = int(anti_aliasing)
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"Unknown kernel_mode: {kernel_mode!r}")
    ds = downsample_mode(aa, pil_exact, downsample)
    h, w = image_size
    tables = prepare(factors, num_sprites, h * aa, w * aa, color_to_rgb,
                     pil_exact)
    if not factors.is_cuda:
        return render_rgb_batch_plain(tables, image_size, bg_color,
                                      downsample)
    if uses_packed(image_size, aa, kernel_mode):
        return packed_raster(tables, image_size, bg_color)
    budget = torch.cuda.get_device_properties(
        factors.device).shared_memory_per_block_optin
    mode = resolve_kernel_mode(
        kernel_mode, scene_smem_bytes(factors.shape[1], tables.num_vertices,
                                      h * aa, w * aa, h, w, ds), budget)
    if mode == "scene":
        return scene_raster(tables, image_size, bg_color, downsample)
    return render_strips(tables, image_size, bg_color, downsample=downsample)


# One scene: a CUDA scene launches the kernel that a batch would.
render_rgb = rasterize.one_scene(render_rgb_batch)


@functools.lru_cache(maxsize=None)
def _scene_launcher():
    """(library, its C launch function with argument types declared)."""
    lib = _build.load("scene_raster")
    fn = lib.scene_raster_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.scene_raster_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.scene_raster_smem_bytes.restype = ctypes.c_longlong
    lib.scene_raster_blocks_per_sm.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int]
    lib.scene_raster_blocks_per_sm.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _strip_launchers():
    """(library, strip_raster_launch, strip_vpass_launch), typed."""
    lib = _build.load("strip_raster")
    fill = lib.strip_raster_launch
    fill.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 12
                     + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p, ctypes.c_void_p])
    fill.restype = ctypes.c_int
    vpass = lib.strip_vpass_launch
    vpass.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p])
    vpass.restype = ctypes.c_int
    lib.strip_raster_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.strip_raster_smem_bytes.restype = ctypes.c_longlong
    lib.strip_raster_blocks_per_sm.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int]
    lib.strip_raster_blocks_per_sm.restype = ctypes.c_int
    return lib, fill, vpass


@functools.lru_cache(maxsize=None)
def _packed_launcher():
    """(library, packed_raster_launch), typed."""
    lib = _build.load("packed_raster")
    fn = lib.packed_raster_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.packed_raster_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_raster_smem_bytes.restype = ctypes.c_longlong
    lib.packed_raster_blocks_per_sm.argtypes = [ctypes.c_longlong,
                                                ctypes.c_int]
    lib.packed_raster_blocks_per_sm.restype = ctypes.c_int
    return lib, fn


def _bg_packed(bg_color) -> int:
    r, g, b = (int(c) for c in (bg_color or (0, 0, 0)))
    return r * 65536 + g * 256 + b


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_launch(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")


def _check_tables(tables: SceneTables, image_size, name: str):
    """(B, K) of a CUDA table the kernels take; raises otherwise."""
    tab = tables.tab
    h, w = image_size
    hc, wc = tables.hc, tables.wc
    v = tables.num_vertices
    if not tab.is_cuda:
        raise ValueError(f"{name} needs a CUDA table; CPU tensors use "
                         "render_rgb_batch_plain")
    if tab.dtype != torch.float32 or not tab.is_contiguous() \
            or tab.dim() != 3 or tab.shape[-1] != table_width(v):
        raise ValueError(f"bad scene table {tuple(tab.shape)} {tab.dtype}")
    b, k, _ = tab.shape
    if hc % h or wc % w or hc // h != wc // w:
        raise ValueError(f"canvas {hc}x{wc} is not a multiple of {h}x{w}")
    if v > 32 or k > 254:
        raise ValueError(f"the kernels take V <= 32, K <= 254 (V={v}, "
                         f"K={k})")
    return b, k


def _table_ds(tables: SceneTables, image_size, downsample: str) -> int:
    return downsample_mode(tables.hc // image_size[0], tables.pil_exact,
                           downsample)


def scene_raster(tables: SceneTables, image_size: Tuple[int, int],
                 bg_color=None, downsample: str = "auto") -> torch.Tensor:
    """Launch the CUDA scene kernel on prepared tables -> u8[B, H, W, 3].

    The tables say which fill; `downsample` is that of
    `ops.rasterize.render_rgb_batch`.
    Runs on the current stream; raises when the kernel cannot launch.
    Each launch adds one to `scene_raster.launches`,
    `scene_raster.by_mode[mode_name(...)]` and `scene_raster.by_batch[B]`.
    """
    b, k = _check_tables(tables, image_size, "scene_raster")
    tab = tables.tab
    h, w = image_size
    hc, wc = tables.hc, tables.wc
    ds = _table_ds(tables, image_size, downsample)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=tab.device)
    if b == 0:
        return out
    if ds == DS_LANCZOS:
        htl, hfr, hks, hqs = lanczos_tiles_on(wc, w, tab.device)
        vtl, vfr, vks, _ = lanczos_tiles_on(hc, h, tab.device)
        cp, hp = htl.pitch, vtl.pitch
        hsteps, vsteps = htl.ksteps, vtl.ksteps
    else:
        hfr = hks = hqs = vfr = vks = None
        cp, hp, hsteps, vsteps = _round16(wc), 0, 0, 0

    lib, launch = _scene_launcher()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(tab), b, k, tables.num_vertices, tab.shape[-1], hc,
                     wc, h, w, int(not tables.pil_exact), ds, _ptr(hfr),
                     _ptr(hks), _ptr(hqs), hsteps, cp, _ptr(vfr), _ptr(vks),
                     vsteps, hp, _bg_packed(bg_color), _ptr(out), stream)
    _check_launch(lib, err, "scene_raster")
    _count_launch(scene_raster, mode_name(tables.pil_exact, ds), b)
    return out


def strip_raster(tables: SceneTables, image_size: Tuple[int, int],
                 bg_color=None, strip_rows: Optional[int] = None,
                 downsample: str = "auto") -> torch.Tensor:
    """Launch the row-strip kernel on prepared tables.

    With the Lanczos filter it returns the h-pass as u8[B, hc, W, 3] in
    Pillow's row order (no flip): a view of the kernel's buffer (see
    `hpass_buffer`), which `strip_vpass` reads as it is. With the box
    filter, or none at anti_aliasing=1, it returns the image u8[B, H, W,
    3]. Box strips hold a multiple of anti_aliasing rows. Runs on the
    current stream; raises when the kernel cannot launch. Each launch adds
    one to `strip_raster.launches`, `strip_raster.by_mode[mode_name(...)]`
    and `strip_raster.by_batch[B]`.
    """
    b, k = _check_tables(tables, image_size, "strip_raster")
    tab = tables.tab
    h, w = image_size
    hc, wc = tables.hc, tables.wc
    aa = hc // h
    ds = _table_ds(tables, image_size, downsample)
    lanczos = ds == DS_LANCZOS
    cp = lanczos_tiles(wc, w).pitch if lanczos else _round16(wc)
    multiple = aa if ds == DS_BOX else 1
    rows = (min(hc, default_strip_rows(hc, cp, 8 if lanczos else multiple))
            if strip_rows is None else int(strip_rows))
    if not 1 <= rows <= hc or rows % multiple:
        raise ValueError(f"strip_rows must lie in [1, {hc}] and be a "
                         f"multiple of {multiple}; got {rows}")
    budget = torch.cuda.get_device_properties(
        tab.device).shared_memory_per_block_optin
    need = strip_smem_bytes(k, rows, wc, w if lanczos else None)
    if need > budget:
        raise ValueError(
            f"a strip of {rows} rows of {wc} pixels needs {need} bytes of "
            f"shared memory; the card gives a block {budget}")
    if lanczos:
        buf, out = hpass_buffer(b, hc, h, w, tab.device)
        _, hfr, hks, hqs = lanczos_tiles_on(wc, w, tab.device)
        hp = hpass_geometry(hc, h, w)[1]
        hsteps = lanczos_tiles(wc, w).ksteps
    else:
        buf = out = torch.empty((b, h, w, 3), dtype=torch.uint8,
                                device=tab.device)
        hfr = hks = hqs = None
        hp = hsteps = 0
    if b == 0:
        return out
    lib, launch, _ = _strip_launchers()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(tab), b, k, tables.num_vertices, tab.shape[-1], hc,
                     wc, h, w, int(not tables.pil_exact), ds, rows, cp,
                     _ptr(hfr), _ptr(hks), _ptr(hqs), hsteps, hp,
                     _bg_packed(bg_color), _ptr(buf), stream)
    _check_launch(lib, err, "strip_raster")
    _count_launch(strip_raster, mode_name(tables.pil_exact, ds), b)
    return out


def hpass_buffer(b: int, hc: int, h: int, w: int, device):
    """(buffer, view) of the strip kernels' h-pass: the buffer is
    u8[B, 3, wp, hp], channel-planar and transposed (output column x's
    canvas rows at bytes 0..hc-1 of row x; `hpass_geometry`), so that the
    v-pass's tensor-core fragments read consecutive canvas rows as words;
    the view is u8[B, hc, w, 3] in Pillow's row order over it."""
    wp, hp = hpass_geometry(hc, h, w)
    buf = torch.empty((b, 3, wp, hp), dtype=torch.uint8, device=device)
    return buf, buf[:, :, :w, :hc].permute(0, 3, 2, 1)


def strip_vpass(hpass: torch.Tensor, h: int) -> torch.Tensor:
    """Launch the vertical Lanczos pass: u8[B, hc, W, 3] (Pillow's row
    order) -> u8[B, h, W, 3] flipped to math orientation. `hpass` must be
    the view of `hpass_buffer` (as `strip_raster` returns it); the kernel
    reads it in place. Each launch adds one to `strip_vpass.launches` and
    `strip_vpass.by_batch[B]`."""
    if not hpass.is_cuda:
        raise ValueError("strip_vpass needs a CUDA tensor; CPU tensors use "
                         "vpass_plain")
    if hpass.dtype != torch.uint8 or hpass.dim() != 4 \
            or hpass.shape[-1] != 3:
        raise ValueError(f"bad h-pass buffer {tuple(hpass.shape)} "
                         f"{hpass.dtype}")
    b, hc, w, _ = hpass.shape
    wp, hp = hpass_geometry(hc, h, w)
    if (hpass.stride() != (3 * wp * hp, 1, hp, wp * hp)
            or hpass.storage_offset() != 0
            or hpass.untyped_storage().nbytes() < b * 3 * wp * hp):
        raise ValueError("strip_vpass reads the view of hpass_buffer that "
                         "strip_raster returns; copy another h-pass into "
                         "such a view first")
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=hpass.device)
    if b == 0:
        return out
    _, vfr, vks, _ = lanczos_tiles_on(hc, h, hpass.device)
    lib, _, launch = _strip_launchers()
    with torch.cuda.device(hpass.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(hpass), b, hp, w, h, _ptr(vfr), _ptr(vks),
                     lanczos_tiles(hc, h).ksteps, _ptr(out), stream)
    _check_launch(lib, err, "strip_vpass")
    _count_launch(strip_vpass, "lanczos", b)
    return out


def render_strips(tables: SceneTables, image_size: Tuple[int, int],
                  bg_color=None, strip_rows: Optional[int] = None,
                  downsample: str = "auto") -> torch.Tensor:
    """The row-strip kernels on prepared CUDA tables -> u8[B, H, W, 3]: the
    strip kernel, then the v-pass kernel with the Lanczos filter."""
    out = strip_raster(tables, image_size, bg_color, strip_rows, downsample)
    if _table_ds(tables, image_size, downsample) != DS_LANCZOS:
        return out  # already the image
    return strip_vpass(out, image_size[0])


def packed_raster(tables: SceneTables, image_size: Tuple[int, int],
                  bg_color=None) -> torch.Tensor:
    """Launch the anti_aliasing=1 small-canvas kernel on prepared tables ->
    u8[B, H, W, 3].

    Any anti_aliasing=1 canvas at most 64 pixels wide (a row is one
    64-bit mask), in tiles of `default_tile_rows` rows; `render_rgb_batch`
    sends it the canvases of `uses_packed`. Runs on the current stream;
    raises when the kernel cannot launch. Each launch adds one to
    `packed_raster.launches`, `packed_raster.by_mode[mode_name(...)]` and
    `packed_raster.by_batch[B]`.
    """
    b, k = _check_tables(tables, image_size, "packed_raster")
    tab = tables.tab
    h, w = image_size
    if tables.hc != h:
        raise ValueError(f"packed_raster renders at anti_aliasing=1; the "
                         f"canvas is {tables.hc}x{tables.wc} for {h}x{w}")
    if w > 64:
        raise ValueError(f"packed_raster renders canvases at most 64 "
                         f"pixels wide; this one is {w}")
    rows = default_tile_rows(h)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=tab.device)
    if b == 0:
        return out
    lib, launch = _packed_launcher()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(tab), b, k, tables.num_vertices, tab.shape[-1], h,
                     w, int(not tables.pil_exact), rows,
                     _bg_packed(bg_color), _ptr(out), stream)
    _check_launch(lib, err, "packed_raster")
    _count_launch(packed_raster,
                  mode_name(tables.pil_exact, DS_IDENTITY), b)
    return out


reset_launch_counts()

# Canvas pixels per step of the plain version: bounds its [chunk, hc, wc]
# temporaries (a few hundred bytes a pixel) whatever the canvas size.
_PLAIN_PIXELS = 1 << 23


def _plain_chunks(tables: SceneTables, max_pixels: int):
    """Sub-tables of at least one scene and at most `max_pixels` canvas
    pixels each, with their batch offsets."""
    step = max(1, max_pixels // (tables.hc * tables.wc))
    for s in range(0, tables.tab.shape[0], step):
        yield s, dataclasses.replace(tables, tab=tables.tab[s:s + step])


def render_rgb_batch_plain(tables: SceneTables, image_size: Tuple[int, int],
                           bg_color=None, downsample: str = "auto", *,
                           max_pixels: int = _PLAIN_PIXELS) -> torch.Tensor:
    """The plain torch version of every kernel -> u8[B, H, W, 3].

    `scene_raster`, the strip kernels (`render_strips`) and
    `packed_raster` are held against it, bit for bit. It works through the
    batch in chunks of at most `max_pixels` canvas pixels (one scene at
    least); the values do not depend on the chunk.
    """
    b = tables.tab.shape[0]
    h, w = image_size
    ds = _table_ds(tables, image_size, downsample)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8,
                      device=tables.tab.device)
    for s, sub in _plain_chunks(tables, max_pixels):
        pix = _plain_pixels(sub, bg_color)
        if ds == DS_IDENTITY:
            img = pix.to(torch.uint8)
        elif ds == DS_LANCZOS:
            img = resample.lanczos_v(resample.lanczos_h(pix, w), h)
        else:
            img = rasterize.box_filter(pix, h, w)
        out[s:s + sub.tab.shape[0]] = torch.flip(img, dims=(1,))
    return out


def hpass_plain(tables: SceneTables, w: int, bg_color=None, *,
                max_pixels: int = _PLAIN_PIXELS) -> torch.Tensor:
    """The plain version of `strip_raster`'s output at anti_aliasing > 1:
    the filled canvas after Pillow's horizontal Lanczos pass,
    u8[B, hc, w, 3] in Pillow's row order."""
    b = tables.tab.shape[0]
    out = torch.empty((b, tables.hc, w, 3), dtype=torch.uint8,
                      device=tables.tab.device)
    for s, sub in _plain_chunks(tables, max_pixels):
        out[s:s + sub.tab.shape[0]] = resample.lanczos_h(
            _plain_pixels(sub, bg_color), w)
    return out


def vpass_plain(hpass: torch.Tensor, h: int) -> torch.Tensor:
    """The plain version of `strip_vpass`: Pillow's vertical pass, then the
    flip to math orientation."""
    return torch.flip(resample.lanczos_v(hpass, h), dims=(1,))


def _plain_fill(tables: SceneTables, k: int) -> torch.Tensor:
    """bool[B, hc, wc]: sprite k's fill inside its pixel bounds."""
    tab = tables.tab[:, k]  # [B, NT]
    hc, wc = tables.hc, tables.wc
    dev = tab.device
    fill = (_plain_fill_exact if tables.pil_exact
            else _plain_fill_centroid)(tables, k)
    # The kernels visit only the sprite's clamped bounds.
    rows = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(wc, dtype=torch.float32, device=dev)
    r0 = tab[:, T_ROW0].clamp(0, hc - 1)[:, None, None]
    r1 = tab[:, T_ROW1].clamp(0, hc - 1)[:, None, None]
    c0 = tab[:, T_COL0].clamp(0, wc - 1)[:, None, None]
    c1 = tab[:, T_COL1].clamp(0, wc - 1)[:, None, None]
    box = (rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)
    count = tab[:, T_COUNT].to(torch.int64)
    return fill & box & (count > 0)[:, None, None]


def _edge_fields(tables: SceneTables, k: int):
    """Sprite k's five per-edge fields, each f32[B, 1, V]."""
    v = tables.num_vertices
    tab = tables.tab[:, k]
    return [tab[:, None, NUM_SCALARS + f * v:NUM_SCALARS + (f + 1) * v]
            for f in range(NUM_EDGE_FIELDS)]


def _plain_fill_centroid(tables: SceneTables, k: int) -> torch.Tensor:
    """bool[B, hc, wc]: points_in_polygons at pixel centres, from the
    centroid tables, with its roundings."""
    hc, wc = tables.hc, tables.wc
    dev = tables.tab.device
    y0, dy, x0, y1, dx = _edge_fields(tables, k)
    py = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None] \
        + 0.5
    straddle = (y0 > py) != (y1 > py)  # [B, hc, V]
    x = torch.where(straddle, x0 + ((py - y0) / dy) * dx, 0.0)
    # Column c counts an edge when c + 0.5 < x, i.e. c < ceil(x - 0.5)
    # (exact in float64): the edge counts for the columns below its bucket.
    t = torch.ceil(x.to(torch.float64) - 0.5).clamp(0, wc).to(torch.int64)
    below = torch.zeros(x.shape[:2] + (wc + 1,), dtype=torch.int32,
                        device=dev)
    below.scatter_add_(-1, t, straddle.to(torch.int32))
    total = straddle.sum(-1, keepdim=True, dtype=torch.int32)
    crossings = total - below[..., :wc].cumsum(-1)
    return (crossings & 1) == 1


def _low_bytes(n: torch.Tensor) -> torch.Tensor:
    """i64 mask of bytes 0 .. n - 1 of a 32-bit word (n clamped to [0, 4])."""
    return (1 << (8 * n.clamp(0, 4))) - 1


def box_words(slots: torch.Tensor, colors: torch.Tensor, aa: int, w: int):
    """The kernels' box filter by words (raster_fill.cuh `box_words`), in
    torch: slots u8[B, h * aa, pitch] (slot bytes, pitch a multiple of 4 and
    at least w * aa; bytes past the w * aa columns are ignored), colors
    i64[B, S]
    packed r << 16 | g << 8 | b by slot, -> (u8[B, h, w, 3] in canvas row
    order, one_slot bool[B, h, w]).

    Each output reads the 32-bit words that hold its aa columns, masked to
    them; its block is one slot when every masked word equals its first
    slot byte replicated, and its colour is then that slot's. Otherwise its
    channel sums are the sums of the masked channel bytes, divided once by
    aa * aa and rounded half to even (`ops.rasterize.box_filter`)."""
    b, hc, pitch = slots.shape
    h = hc // aa
    dev = slots.device
    words = slots.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    x = torch.arange(w, device=dev)
    off = (x * aa) & 3
    nw = (off + aa + 3) >> 2
    nmax = int(nw.max())
    q = torch.arange(nmax, device=dev)[:, None]  # [nmax, w]
    full = 0xffffffff
    mask = torch.where(q == 0, full & ~_low_bytes(off)[None], full)
    mask = mask & torch.where(q == nw - 1,
                              _low_bytes(off + aa - 4 * (nw - 1)), full)
    mask = torch.where(q < nw, mask, 0)
    idx = ((x * aa) >> 2)[None] + torch.where(q < nw, q, 0)  # [nmax, w]
    blocks = words.reshape(b, h, aa, pitch // 4)[..., idx]  # [b,h,aa,nmax,w]
    first = slots.reshape(b, h, aa, pitch)[:, :, 0, x * aa].to(torch.int64)
    rep = first * 0x01010101  # [b, h, w]
    diff = ((blocks ^ rep[:, :, None, None]) & mask).amax((2, 3))
    one_slot = diff == 0
    chans = torch.stack([colors >> 16, (colors >> 8) & 255, colors & 255],
                        -1)  # [B, S, 3]
    sums = torch.zeros((b, h, w, 3), dtype=torch.int64, device=dev)
    for j in range(4):
        keep = ((mask >> (8 * j)) & 255) == 255
        slot_j = torch.where(keep, (blocks >> (8 * j)) & 255, 0)
        c = chans.gather(1, slot_j.reshape(b, -1, 1).expand(-1, -1, 3))
        c = c.reshape(slot_j.shape + (3,))
        sums += (c * keep[..., None]).sum((2, 3))
    sums = sums.to(torch.float32)
    mean = torch.round(sums / torch.full_like(sums, aa * aa))
    colour = chans.gather(1, first.reshape(b, -1, 1).expand(-1, -1, 3))
    out = torch.where(one_slot[..., None],
                      colour.reshape(b, h, w, 3).to(torch.float32), mean)
    return out.to(torch.uint8), one_slot


def _cols_from(t: torch.Tensor) -> torch.Tensor:
    """i64 64-bit masks (two's complement) of the columns c >= t."""
    m = torch.bitwise_left_shift(torch.full_like(t, -1), t.clamp(0, 63))
    return torch.where(t >= 64, torch.zeros_like(m), m)


def _col_range(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """i64 masks of the columns a..b (none when a > b)."""
    m = _cols_from(a) & ~_cols_from(b + 1)
    return torch.where(a > b, torch.zeros_like(m), m)


def _fold(x, w, parity, window):
    """packed_raster.cu `fold`: a crossing x of weight w flips the parity
    of the columns c with x <= c - 0.5 (from t, found by floor and one
    compare) and marks its window column t - 1 unless x lies on a pixel
    boundary."""
    f = torch.floor(x).clamp(-2.0, 65.0)
    half = f + 0.5
    t = f.to(torch.int64) + torch.where(x <= half, 1, 2)
    parity = parity ^ torch.where((w & 1) == 1, _cols_from(t), 0)
    s = t - 1
    bit = torch.bitwise_left_shift(torch.ones_like(s), s.clamp(0, 63))
    on = (w > 0) & (x != half) & (s >= 0) & (s < 64)
    return parity, window | torch.where(on, bit, 0)


def packed_row_masks(tables: SceneTables, k: int) -> torch.Tensor:
    """i64[B, hc]: sprite k's columns on each canvas row as the packed
    kernel computes them (csrc/packed_raster.cu `exact_row`,
    `centroid_row`, the staged feature and column masks), bit c for column
    c of a canvas at most 64 wide; 0 on rows outside the sprite's row
    bounds and for a dead sprite. The edges are walked in order with the
    first row maximum held aside for the odd-total trim, crossings become
    integer column thresholds, and parities and windows 64-bit masks."""
    tab = tables.tab[:, k]  # [B, NT]
    hc, wc = tables.hc, tables.wc
    dev = tab.device
    v = tables.num_vertices
    rf = torch.arange(hc, dtype=torch.float32, device=dev)[None, :]
    zero = torch.zeros((tab.shape[0], hc), dtype=torch.int64, device=dev)
    fields = [f[:, 0] for f in _edge_fields(tables, k)]  # each [B, V]
    if tables.pil_exact:
        y0, m, x0, ymn, ymx = fields
        gymax = tab[:, T_GYMAX, None]
        parity, window = zero, zero
        total, hw = zero, zero
        hx = torch.full((tab.shape[0], hc), -_BIG, device=dev)
        for e in range(v):  # edges past the count never weigh
            inr = (rf >= ymn[:, e, None]) & (rf <= ymx[:, e, None])
            dup = inr & (rf == ymx[:, e, None]) & (ymx[:, e, None] < gymax)
            w = inr.to(torch.int64) + dup.to(torch.int64)
            total = total + w
            xi = x0[:, e, None] + (rf - y0[:, e, None]) * m[:, e, None]
            top = (w > 0) & (xi > hx)
            fx = torch.where(top, hx, xi)
            fw = torch.where(top, hw, w)
            hx = torch.where(top, xi, hx)
            hw = torch.where(top, w, hw)
            parity, window = _fold(fx, fw, parity, window)
        parity, window = _fold(hx, hw - (total & 1), parity, window)
        feats = tables.features()[:, k]  # [B, 2V, 3]
        nf = tab[:, T_NF].to(torch.int64)
        lo = torch.ceil(feats[..., 1]).clamp(0, 64).to(torch.int64)
        hi = torch.floor(feats[..., 2]).clamp(-1, 63).to(torch.int64)
        fmask = _col_range(lo, hi)  # [B, 2V]
        row = feats[..., 0]
        live = ((torch.arange(2 * v, device=dev)[None] < nf[:, None])
                & (row == torch.floor(row)))
        on = zero
        for j in range(2 * v):
            hit = live[:, j, None] & (row[:, j, None] == rf)
            on = on | torch.where(hit, fmask[:, j, None], 0)
        mask = parity | window | on
    else:
        y0, dy, x0, y1, dx = fields
        py = rf + 0.5
        mask = zero
        for e in range(v):  # dead edges have y1 == y0: no straddle
            straddle = ((y0[:, e, None] > py) != (y1[:, e, None] > py))
            x = x0[:, e, None] + ((py - y0[:, e, None]) / dy[:, e, None]) \
                * dx[:, e, None]
            f = torch.floor(x).clamp(-2.0, 65.0)
            u = f.to(torch.int64) + (x > f + 0.5).to(torch.int64)
            mask = mask ^ torch.where(straddle, ~_cols_from(u), 0)
    c0 = tab[:, T_COL0].to(torch.int64).clamp(min=0)
    c1 = tab[:, T_COL1].to(torch.int64).clamp(max=wc - 1)
    rows_in = ((rf >= tab[:, T_ROW0, None].trunc())
               & (rf <= tab[:, T_ROW1, None].trunc())
               & (tab[:, T_COUNT, None].to(torch.int64) > 0))
    return torch.where(rows_in, mask & _col_range(c0, c1)[:, None], 0)


def exact_crossings(tables: SceneTables, k: int):
    """(xi f32[B, hc, V], weight i32[B, hc, V]): sprite k's crossing of each
    canvas row by each edge and its Pillow weight after the odd-total trim
    (0 where the edge does not cross the row), from the exact tables."""
    tab = tables.tab[:, k]  # [B, NT]
    dev = tab.device
    v = tables.num_vertices
    rows = torch.arange(tables.hc, dtype=torch.float32,
                        device=dev)[None, :, None]
    y0, m, x0, ymn, ymx = _edge_fields(tables, k)
    gymax = tab[:, None, None, T_GYMAX]
    prod = (rows - y0) * m
    xi = x0 + prod  # [B, hc, V]
    inr = (rows >= ymn) & (rows <= ymx)
    dup = inr & (rows == ymx) & (ymx < gymax)
    wgt = inr.to(torch.int32) + dup.to(torch.int32)
    # Odd-total trim: drop one instance (the first) of the row maximum.
    odd = (wgt.sum(-1, keepdim=True) & 1) == 1
    rmax = torch.where(wgt > 0, xi, torch.full_like(xi, -_BIG)).amax(
        -1, keepdim=True)
    ismax = (wgt > 0) & (xi == rmax)
    vidx = torch.arange(v, device=dev)
    fidx = torch.where(ismax, vidx, v).amin(-1, keepdim=True)
    return xi, wgt - (odd & ismax & (vidx == fidx)).to(torch.int32)


def _plain_fill_exact(tables: SceneTables, k: int) -> torch.Tensor:
    """bool[B, hc, wc]: Pillow's exact fill from the exact tables."""
    hc, wc = tables.hc, tables.wc
    tab = tables.tab[:, k]  # [B, NT]
    dev = tab.device
    v = tables.num_vertices
    rows = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None]
    xi, wgt = exact_crossings(tables, k)

    # Column c counts an edge in `le` when xi <= c - 0.5 and in its window
    # when c - 0.5 < xi < c + 0.5. xi + 0.5 is exact in float64, so the
    # buckets ceil(xi + 0.5) and floor(xi + 0.5) decide both tests exactly.
    xd = xi.to(torch.float64) + 0.5
    t = torch.ceil(xd).clamp(0, wc).to(torch.int64)  # wc = never counted
    le = torch.zeros(xi.shape[:2] + (wc + 1,), dtype=torch.int32, device=dev)
    le.scatter_add_(-1, t, wgt & 1)
    le_odd = (le[..., :wc].cumsum(-1) & 1) == 1
    s = torch.floor(xd)
    s_ok = (xd != s) & (s >= 0) & (s <= wc - 1)
    s_i = torch.where(s_ok, s, float(wc)).to(torch.int64)
    win = torch.zeros_like(le)
    win.scatter_add_(-1, s_i, wgt)
    fill = le_odd | (win[..., :wc] > 0)

    feats = tables.features()[:, k]  # [B, 2V, 3]
    nf = tab[:, T_NF].to(torch.int64)
    fact = torch.arange(2 * v, device=dev) < nf[:, None]
    cols = torch.arange(wc, dtype=torch.float32, device=dev)
    rowhit = ((rows[:, :, 0:1] == feats[:, None, :, 0])
              & fact[:, None, :]).to(torch.float32)         # [B, hc, 2V]
    colhit = ((cols >= feats[..., 1:2])
              & (cols <= feats[..., 2:3])).to(torch.float32)  # [B, 2V, wc]
    return fill | (torch.bmm(rowhit, colhit) > 0)


def _plain_pixels(tables: SceneTables, bg_color) -> torch.Tensor:
    """i64[B, hc, wc, 3]: the painted canvas in Pillow's row order."""
    tab = tables.tab
    b, k, _ = tab.shape
    dev = tab.device
    hc, wc = tables.hc, tables.wc
    # Canvas of slot indices: 0 = background, k + 1 = sprite k on top.
    canvas = torch.zeros((b, hc, wc), dtype=torch.int64, device=dev)
    for i in range(k):
        canvas = torch.where(_plain_fill(tables, i), i + 1, canvas)
    packed = torch.cat([
        torch.full((b, 1), float(_bg_packed(bg_color)), device=dev),
        tab[..., T_COLOR]], -1).to(torch.int64)  # [B, K + 1]
    rgb = torch.stack([packed // 65536, (packed // 256) % 256, packed % 256],
                      -1)  # [B, K + 1, 3]
    pix = rgb.gather(1, canvas.reshape(b, -1, 1).expand(-1, -1, 3))
    return pix.reshape(b, hc, wc, 3)
