"""Rasterizer for the card: two hand-written CUDA kernels and their plain twin.

Counterpart of `spriteworld_tpu/ops/rasterize_pallas.py`'s scene kernel
(`_fill_kernel_scene`), its row-strip kernel (`_fill_kernel` in strip mode)
and their host preparation (`_prepare`, `_build_edge_tables`). Same
contract as `ops/rasterize.py`: paint sprite polygons back-to-front on an
`anti_aliasing`-supersampled canvas with Pillow's exact scanline fill,
downsample with Pillow's Lanczos filter (or not at all at
anti_aliasing=1), flip to math coordinates.

The work splits in four:

* `prepare` turns factors into one packed per-sprite table: scalars
  (vertex count, feature count, packed colour, global bottom row, pixel
  bounds), the per-edge fields of the scanline fill and Pillow's
  horizontal-edge and wedge features compacted to (row, lo, hi) integer
  intervals. Only plain elementwise torch operations are used, so nothing
  fuses into an FMA.
* `scene_raster` launches the scene kernel (`csrc/scene_raster.cu`) on a
  CUDA table: one thread block renders one whole scene, its canvas in
  shared memory.
* `strip_raster` and `strip_vpass` launch the row-strip kernels
  (`csrc/strip_raster.cu`): one block fills one strip of canvas rows and
  runs the horizontal Lanczos pass; a second kernel runs the vertical pass.
  They take the canvases whose scene layout does not fit one block's
  shared memory (`render_rgb_batch`'s `kernel_mode="auto"`).
* `render_rgb_batch_plain` computes the same function from the same table
  with torch operations. CPU tensors take it; on the card both kernels are
  held against it, bit for bit (`hpass_plain` and `vpass_plain` are its two
  Lanczos passes, for holding the strip kernels against it one at a time).

All evaluate the crossing of an edge with a scanline as the float32
multiply-then-add ``x0 + (row - y0) * m``, and all downsample with Pillow's
integer taps, exactly; so the kernels and the plain version agree on every
value, and all agree with Pillow.
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
from spriteworld_torch.ops import rasterize
from spriteworld_torch.ops import resample
from spriteworld_torch.utils import device as device_lib

_BIG = 1e9

# Scalar fields at the head of each sprite's table row.
(T_COUNT, T_NF, T_COLOR, T_GYMAX,
 T_ROW0, T_ROW1, T_COL0, T_COL1) = range(8)
NUM_SCALARS = 8
# Per-edge fields that follow, each a block of V values.
E_Y0, E_M, E_X0, E_YMIN, E_YMAX = range(5)
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

    tab: f32[B, K, table_width(V)] — every value is an exact integer except
    the edge slopes `m`; colours are packed as r*65536 + g*256 + b.
    """

    tab: torch.Tensor
    num_vertices: int
    hc: int
    wc: int

    def features(self):
        """f32[B, K, 2V, 3] of (row, lo, hi); the first `nf` are active."""
        v = self.num_vertices
        start = NUM_SCALARS + NUM_EDGE_FIELDS * v
        return self.tab[..., start:].reshape(self.tab.shape[:-1] + (2 * v, 3))


def prepare(factors: torch.Tensor, num_sprites: torch.Tensor, hc: int,
            wc: int, color_to_rgb: Optional[Callable]) -> SceneTables:
    """Per-scene tables for the exact fill of factors[B, K, 10]."""
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

    v = torch.trunc(verts_c)
    x0, y0 = v[..., 0], v[..., 1]
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    valid = torch.arange(vmax, device=dev) < counts[..., None]
    horiz = (y0 == y1) & valid
    slant = (y0 != y1) & valid
    dy = torch.where(y1 == y0, torch.ones_like(y1), y1 - y0)
    m = (x1 - x0) / dy
    ymin_e = torch.minimum(y0, y1)
    ymax_e = torch.maximum(y0, y1)
    big = torch.full_like(y0, _BIG)
    gymax = torch.where(valid, ymax_e, -big).amax(-1)  # [B, K]

    # Features: horizontal edges fill [min x, max x] on their row; wedges
    # fill [lo, hi] on their vertex row. Active ones are compacted to the
    # front (a stable partition), the rest zeroed.
    wact, wlo, whi = rasterize.wedge_intervals(x0, y0, valid, counts, gymax)
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

    # Conservative pixel bounds: wedges reach round_half_up(u) +- 1 of an
    # edge intersection inside the vertex x-extent; pair and window fills
    # reach at most the extent + 0.5.
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
    edges = torch.cat([
        y0, m, x0,
        torch.where(slant, ymin_e, big),
        torch.where(slant, ymax_e, -big)], -1)  # [B, K, 5V]
    tab = torch.cat([scal, edges, feats.reshape(b, k, 6 * vmax)], -1)
    return SceneTables(tab=tab.contiguous(), num_vertices=vmax, hc=hc, wc=wc)


@functools.lru_cache(maxsize=None)
def _lanczos_taps_host(in_size: int, out_size: int):
    """(start i32[out], q i32[out, T]) with every read inside [0, in_size).

    Windows are padded with zero taps to one width T; a window near the far
    edge starts earlier, its taps shifted right, so the kernel reads T
    inputs from `start` without bounds checks.
    """
    xmins, taps = resample.pil_lanczos_fixed(in_size, out_size)
    width = max(len(q) for q in taps)
    start = np.minimum(xmins, in_size - width).astype(np.int32)
    q = np.zeros((out_size, width), np.int64)
    for o, (xmin, t) in enumerate(zip(xmins, taps)):
        off = xmin - start[o]
        q[o, off:off + len(t)] = t
    # The kernel sums 2^21 + q * p (p <= 255) in int32, as Pillow does.
    if np.abs(q).sum(1).max() * 255 + (1 << 21) >= 1 << 31:
        raise ValueError("Lanczos taps overflow an int32 accumulator")
    return start, q.astype(np.int32)


def lanczos_taps(in_size: int, out_size: int, device):
    start, q = _lanczos_taps_host(in_size, out_size)
    return (device_lib.constant(start, device),
            device_lib.constant(q, device))


def lanczos_taps_t(in_size: int, out_size: int, device):
    """(start, q transposed to i32[T, out]) for the strip kernel's h-pass:
    a warp's neighbouring outputs read neighbouring words of each tap."""
    start, q = _lanczos_taps_host(in_size, out_size)
    return (device_lib.constant(start, device),
            device_lib.constant(np.ascontiguousarray(q.T), device))


def kernel_covers(anti_aliasing: int, pil_exact: bool,
                  downsample: str) -> bool:
    """Whether the kernels compute this render mode: the exact fill with
    Lanczos downsampling, or with none at anti_aliasing=1."""
    if downsample == "auto":
        downsample = "lanczos" if pil_exact else "box"
    return pil_exact and (anti_aliasing == 1 or downsample == "lanczos")


def _round16(n: int) -> int:
    return (n + 15) & ~15


_SCENE_WARPS = 16  # scene_raster.cu kThreads / 32
_STRIP_WARPS = 8  # strip_raster.cu kThreads / 32


def _tap_widths(hc: int, wc: int, h: int, w: int) -> Tuple[int, int]:
    """(h-pass, v-pass) padded tap counts; 0 at anti_aliasing=1."""
    if hc == h:
        return 0, 0
    return (_lanczos_taps_host(wc, w)[1].shape[1],
            _lanczos_taps_host(hc, h)[1].shape[1])


def scene_smem_bytes(k: int, num_vertices: int, hc: int, wc: int, h: int,
                     w: int) -> int:
    """Shared memory of one scene_raster block: a mirror of `layout` in
    csrc/scene_raster.cu (chip_smoke.py holds the two equal)."""
    ht, vt = _tap_widths(hc, wc, h, w)
    words = (k * table_width(num_vertices) + k + 1 + 2 * _SCENE_WARPS * 32
             + (w if ht else 0) + w * ht + (h if vt else 0) + h * vt)
    canvas = _round16(words * 4)
    hpass = canvas + _round16(hc * wc)
    return hpass + (_round16(hc * w * 3) if ht else 0)


def strip_smem_bytes(k: int, strip_rows: int, wc: int) -> int:
    """Shared memory of one strip_raster block: a mirror of `layout` in
    csrc/strip_raster.cu."""
    return (_round16((k + 1 + 2 * _STRIP_WARPS * 32) * 4)
            + _round16(strip_rows * wc))


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


# Canvas bytes a strip block keeps in shared memory by default: small
# enough for three blocks on one SM.
_STRIP_CANVAS_BYTES = 64 * 1024


def default_strip_rows(hc: int, wc: int) -> int:
    """Canvas rows per strip: as many as fit `_STRIP_CANVAS_BYTES`."""
    return max(1, min(hc, _STRIP_CANVAS_BYTES // wc))


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
    """Render factors[B, K, 10] to u8[B, H, W, 3] (math orientation).

    CUDA tensors launch a kernel: the scene kernel when `kernel_mode`
    resolves to "scene" (see `resolve_kernel_mode`; "auto" decides from the
    card's shared memory per block before launching), the row-strip kernels
    otherwise. CPU tensors take the plain version, whatever the mode. Same
    arguments as `ops.rasterize.render_rgb`; the modes the kernels do not
    cover raise NotImplementedError.
    """
    aa = int(anti_aliasing)
    if not kernel_covers(aa, pil_exact, downsample):
        raise NotImplementedError(
            "the kernels cover pil_exact=True with Lanczos (or, at "
            "anti_aliasing=1, no) downsampling; the centroid fill and the "
            "box filter on the card are ROADMAP Queue 2 item 1b "
            f"(got pil_exact={pil_exact}, downsample={downsample!r})")
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"Unknown kernel_mode: {kernel_mode!r}")
    h, w = image_size
    tables = prepare(factors, num_sprites, h * aa, w * aa, color_to_rgb)
    if not factors.is_cuda:
        return render_rgb_batch_plain(tables, image_size, bg_color)
    budget = torch.cuda.get_device_properties(
        factors.device).shared_memory_per_block_optin
    mode = resolve_kernel_mode(
        kernel_mode, scene_smem_bytes(factors.shape[1], tables.num_vertices,
                                      h * aa, w * aa, h, w), budget)
    if mode == "scene":
        return scene_raster(tables, image_size, bg_color)
    return render_strips(tables, image_size, bg_color)


@functools.lru_cache(maxsize=None)
def _scene_launcher():
    """(library, its C launch function with argument types declared)."""
    lib = _build.load("scene_raster")
    fn = lib.scene_raster_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.scene_raster_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.scene_raster_smem_bytes.restype = ctypes.c_longlong
    return lib, fn


@functools.lru_cache(maxsize=None)
def _strip_launchers():
    """(library, strip_raster_launch, strip_vpass_launch), typed."""
    lib = _build.load("strip_raster")
    fill = lib.strip_raster_launch
    fill.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 9
                     + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fill.restype = ctypes.c_int
    vpass = lib.strip_vpass_launch
    vpass.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p])
    vpass.restype = ctypes.c_int
    lib.strip_raster_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.strip_raster_smem_bytes.restype = ctypes.c_longlong
    return lib, fill, vpass


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


def scene_raster(tables: SceneTables, image_size: Tuple[int, int],
                 bg_color=None) -> torch.Tensor:
    """Launch the CUDA scene kernel on prepared tables -> u8[B, H, W, 3].

    Runs on the current stream; raises when the kernel cannot launch.
    Each launch adds one to `scene_raster.launches`.
    """
    b, k = _check_tables(tables, image_size, "scene_raster")
    tab = tables.tab
    h, w = image_size
    hc, wc = tables.hc, tables.wc
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=tab.device)
    if b == 0:
        return out
    if hc == h:  # anti_aliasing=1: identity downsample
        hx0 = hq = vy0 = vq = None
        ht = vt = 0
    else:
        hx0, hq = lanczos_taps(wc, w, tab.device)
        vy0, vq = lanczos_taps(hc, h, tab.device)
        ht, vt = hq.shape[1], vq.shape[1]

    lib, launch = _scene_launcher()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(tab), b, k, tables.num_vertices, tab.shape[-1], hc,
                     wc, h, w, _ptr(hx0), _ptr(hq), ht, _ptr(vy0), _ptr(vq),
                     vt, _bg_packed(bg_color), _ptr(out), stream)
    _check_launch(lib, err, "scene_raster")
    scene_raster.launches += 1
    return out


scene_raster.launches = 0


def strip_raster(tables: SceneTables, image_size: Tuple[int, int],
                 bg_color=None, strip_rows: Optional[int] = None
                 ) -> torch.Tensor:
    """Launch the row-strip kernel on prepared tables.

    Returns the h-pass u8[B, hc, W, 3] in Pillow's row order (no flip), or
    at anti_aliasing=1 the image u8[B, H, W, 3]. Runs on the current
    stream; raises when the kernel cannot launch. Each launch adds one to
    `strip_raster.launches`.
    """
    b, k = _check_tables(tables, image_size, "strip_raster")
    tab = tables.tab
    h, w = image_size
    hc, wc = tables.hc, tables.wc
    rows = default_strip_rows(hc, wc) if strip_rows is None else int(
        strip_rows)
    if not 1 <= rows <= hc:
        raise ValueError(f"strip_rows must lie in [1, {hc}]; got {rows}")
    budget = torch.cuda.get_device_properties(
        tab.device).shared_memory_per_block_optin
    if strip_smem_bytes(k, rows, wc) > budget:
        raise ValueError(
            f"a strip of {rows} rows of {wc} pixels needs "
            f"{strip_smem_bytes(k, rows, wc)} bytes of shared memory; the "
            f"card gives a block {budget}")
    out = torch.empty((b, hc, w, 3), dtype=torch.uint8, device=tab.device)
    if b == 0:
        return out
    if hc == h:
        hx0 = hqt = None
        ht = 0
    else:
        hx0, hqt = lanczos_taps_t(wc, w, tab.device)
        ht = hqt.shape[0]
    lib, launch, _ = _strip_launchers()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(tab), b, k, tables.num_vertices, tab.shape[-1], hc,
                     wc, h, w, rows, _ptr(hx0), _ptr(hqt), ht,
                     _bg_packed(bg_color), _ptr(out), stream)
    _check_launch(lib, err, "strip_raster")
    strip_raster.launches += 1
    return out


strip_raster.launches = 0


def strip_vpass(hpass: torch.Tensor, h: int) -> torch.Tensor:
    """Launch the vertical Lanczos pass: u8[B, hc, W, 3] (Pillow's row
    order) -> u8[B, h, W, 3] flipped to math orientation. Each launch adds
    one to `strip_vpass.launches`."""
    if not hpass.is_cuda:
        raise ValueError("strip_vpass needs a CUDA tensor; CPU tensors use "
                         "vpass_plain")
    if hpass.dtype != torch.uint8 or hpass.dim() != 4 \
            or hpass.shape[-1] != 3 or not hpass.is_contiguous():
        raise ValueError(f"bad h-pass buffer {tuple(hpass.shape)} "
                         f"{hpass.dtype}")
    b, hc, w, _ = hpass.shape
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=hpass.device)
    if b == 0:
        return out
    vy0, vq = lanczos_taps(hc, h, hpass.device)
    lib, _, launch = _strip_launchers()
    with torch.cuda.device(hpass.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(_ptr(hpass), b, hc, w, h, _ptr(vy0), _ptr(vq),
                     vq.shape[1], _ptr(out), stream)
    _check_launch(lib, err, "strip_vpass")
    strip_vpass.launches += 1
    return out


strip_vpass.launches = 0


def render_strips(tables: SceneTables, image_size: Tuple[int, int],
                  bg_color=None, strip_rows: Optional[int] = None
                  ) -> torch.Tensor:
    """The row-strip kernels on prepared CUDA tables -> u8[B, H, W, 3]."""
    out = strip_raster(tables, image_size, bg_color, strip_rows)
    if tables.hc == image_size[0]:  # anti_aliasing=1: already the image
        return out
    return strip_vpass(out, image_size[0])


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
                           bg_color=None, *,
                           max_pixels: int = _PLAIN_PIXELS) -> torch.Tensor:
    """The plain torch version of both kernels -> u8[B, H, W, 3].

    Both `scene_raster` and the strip kernels (`render_strips`) are held
    against it, bit for bit. It works through the batch in chunks of at
    most `max_pixels` canvas pixels (one scene at least); the values do not
    depend on the chunk.
    """
    b = tables.tab.shape[0]
    h, w = image_size
    out = torch.empty((b, h, w, 3), dtype=torch.uint8,
                      device=tables.tab.device)
    for s, sub in _plain_chunks(tables, max_pixels):
        pix = _plain_pixels(sub, bg_color)
        if tables.hc == h:
            img = pix.to(torch.uint8)
        else:
            img = resample.lanczos_v(resample.lanczos_h(pix, w), h)
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
    """bool[B, hc, wc]: sprite k's exact fill inside its pixel bounds."""
    hc, wc = tables.hc, tables.wc
    tab = tables.tab[:, k]  # [B, NT]
    dev = tab.device
    v = tables.num_vertices

    def edge(field):
        start = NUM_SCALARS + field * v
        return tab[:, None, start:start + v]  # [B, 1, V]

    rows = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None]
    y0, m, x0 = edge(E_Y0), edge(E_M), edge(E_X0)
    ymn, ymx = edge(E_YMIN), edge(E_YMAX)
    gymax = tab[:, None, None, T_GYMAX]
    count = tab[:, T_COUNT].to(torch.int64)
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
    wgt = wgt - (odd & ismax & (vidx == fidx)).to(torch.int32)

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
    fill = fill | (torch.bmm(rowhit, colhit) > 0)

    # The kernel visits only the sprite's clamped bounds.
    r0 = tab[:, T_ROW0].clamp(0, hc - 1)[:, None, None]
    r1 = tab[:, T_ROW1].clamp(0, hc - 1)[:, None, None]
    c0 = tab[:, T_COL0].clamp(0, wc - 1)[:, None, None]
    c1 = tab[:, T_COL1].clamp(0, wc - 1)[:, None, None]
    r = rows[:, :, 0:1]
    box = (r >= r0) & (r <= r1) & (cols >= c0) & (cols <= c1)
    return fill & box & (count > 0)[:, None, None]


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
