"""Plain polygon rasterizer: painter's-algorithm scene rendering.

Counterpart of `spriteworld_tpu/ops/rasterize.py` (the XLA rasterizer):
draw filled sprite polygons back-to-front on an `anti_aliasing`-supersampled
canvas, downsample, and flip vertically to math coordinates.

Two polygon-fill modes:

* ``pil_exact=True`` (default): Pillow's integer scanline fill, per pixel
  and without sorting. Vertices are truncated to integers; on each scanline
  every slanted edge whose inclusive y-range holds the row crosses it at
  ``xi = x0 + (row - y0) * m`` (a multiply, then an add: never one fused
  operation), and counts twice at its lower endpoint above the global
  bottom. A pixel of column c is filled where

      odd(#{xi <= c - 0.5})  or  some xi lies in (c - 0.5, c + 0.5),

  with one instance of the row maximum removed when the row's total is
  odd. Horizontal edges and the wedge extensions at one-sided top vertices
  and global-bottom vertices add closed integer column intervals on single
  rows. The parity and window tests use the same float32 bucket arithmetic
  as the JAX rasterizer (``ceil(xi + 0.5)``, ``floor(xi + 0.5)``), with
  per-row counts kept as scatter-added column histograms instead of bit
  words.

* ``pil_exact=False``: even-odd crossing test at pixel centers.

`render_rgb_batch` renders a batch ``factors[B, K, 10]``, a bounded number
of scenes at a time; `render_rgb` renders one scene ``factors[K, 10]``, as
the JAX function of that name does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from spriteworld_torch import constants
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import geometry
from spriteworld_torch.ops import resample
from spriteworld_torch.utils import device as device_lib

_BIG = 1e9
# Scenes rendered together: bounds the [chunk, hc, V] and [chunk, hc, wc]
# temporaries of a large canvas.
_SCENE_CHUNK = 64


def _round_half_up(f):
    """Pillow's ROUND_UP: round half away from zero."""
    return torch.where(f >= 0, torch.floor(f + 0.5), -torch.floor(0.5 - f))


# The float just above -0.5.
ABOVE_NEG_HALF = float(np.nextafter(np.float32(-0.5), np.float32(0)))


def pillow_crossing(xi):
    """A scanline crossing as the fill counts it: -0.5 becomes the float
    just above it. Pillow rounds a negative half away from zero, so a span
    that ends at -0.5 ends at column 0: the nudged crossing lies in column
    0's window, c - 0.5 < x < c + 0.5, and every column from 1 on counts
    it as before."""
    return torch.where(xi == -0.5, ABOVE_NEG_HALF, xi)


def _canvas_vertices(factors, hc: int, wc: int):
    """World vertices scaled to PIL canvas coordinates (x*W, y*H)."""
    verts = geometry.world_vertices(factors)  # [..., V, 2]
    scale = device_lib.constant(np.array([wc, hc], np.float32), verts.device)
    return verts * scale


def _cyclic_neighbor(x0, y0, count, direction: int):
    """Nearest distinct cyclic neighbor within 3 steps of every vertex.

    Consecutive duplicate (truncation-collided) points are skipped. Returns
    (nx, ny, found), each [..., V].
    """
    vmax = x0.shape[-1]
    idx = torch.arange(vmax, device=x0.device)
    n = count.clamp(min=1)[..., None]
    nx = torch.zeros_like(x0)
    ny = torch.zeros_like(y0)
    found = torch.zeros_like(x0, dtype=torch.bool)
    for step in (1, 2, 3):
        j = torch.remainder(idx + direction * step, n)
        cx = x0.gather(-1, j)
        cy = y0.gather(-1, j)
        differs = (cx != x0) | (cy != y0)
        take = (~found) & differs
        nx = torch.where(take, cx, nx)
        ny = torch.where(take, cy, ny)
        found = found | differs
    return nx, ny, found


def wedge_intervals(x0, y0, valid, count, gymax):
    """Pillow's wedge extensions at vertices, as closed column intervals.

    x0, y0: truncated vertices [..., V]; valid: bool [..., V]; count: [...];
    gymax: [...] global bottom row. Returns (active, lo, hi), each [..., V],
    with lo > hi where no wedge applies.
    """
    px, py, pf = _cyclic_neighbor(x0, y0, count, -1)
    nx, ny, nf = _cyclic_neighbor(x0, y0, count, +1)
    vx, vy = x0, y0
    one = torch.ones_like(vy)
    ok = valid & pf & nf & (py != vy) & (ny != vy)
    is_top = ok & (py > vy) & (ny > vy)
    is_gbot = ok & (py < vy) & (ny < vy) & (vy == gymax[..., None])
    adj = torch.where(is_top, vy + 1.0, vy - 1.0)
    u1 = vx + (adj - vy) * (px - vx) / torch.where(py == vy, one, py - vy)
    u2 = vx + (adj - vy) * (nx - vx) / torch.where(ny == vy, one, ny - vy)
    active = is_top | is_gbot
    right_side = active & (u1 > vx) & (u2 > vx)
    left_side = active & (u1 < vx) & (u2 < vx)
    # right: [vx, round_up(min_u)-1];  left: [round_up(max_u)+1, vx]
    min_u = torch.minimum(u1, u2)
    max_u = torch.maximum(u1, u2)
    big = torch.full_like(vx, _BIG)
    lo = torch.where(right_side, vx,
                     torch.where(left_side, _round_half_up(max_u) + 1.0, big))
    hi = torch.where(right_side, _round_half_up(min_u) - 1.0,
                     torch.where(left_side, vx, -big))
    return right_side | left_side, lo, hi


def _pil_polygon_mask(verts_c, count, hc: int, wc: int):
    """Pixel-exact Pillow fill of a batch of polygons on the canvas.

    Args:
      verts_c: f32[N, V, 2] canvas-space vertices (padding repeats vertex 0).
      count: i32[N] true vertex counts.
      hc, wc: canvas height/width.

    Returns:
      bool[N, hc, wc] in PIL orientation (row 0 = top).
    """
    dev = verts_c.device
    v = torch.trunc(verts_c)
    vmax = v.shape[-2]
    idx = torch.arange(vmax, device=dev)
    x0, y0 = v[..., 0], v[..., 1]
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    valid = idx < count[:, None]  # edges i -> i+1 (wrap = closing edge)
    horiz = (y0 == y1) & valid
    slant = (y0 != y1) & valid

    ymin_e = torch.minimum(y0, y1)
    ymax_e = torch.maximum(y0, y1)
    gymax = torch.where(valid, ymax_e, torch.full_like(ymax_e, -_BIG)).amax(-1)

    rows = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(wc, dtype=torch.float32, device=dev)

    # --- scanline pair fill ------------------------------------------- #
    e = (slice(None), None, slice(None))  # [N, V] -> [N, 1, V]
    inr = slant[e] & (rows >= ymin_e[e]) & (rows <= ymax_e[e])  # [N, H, V]
    dy = torch.where(y1 == y0, torch.ones_like(y1), y1 - y0)
    m = (x1 - x0) / dy
    prod = (rows - y0[e]) * m[e]
    xi = pillow_crossing(x0[e] + prod)  # [N, H, V]
    dup = inr & (rows == ymax_e[e]) & (ymax_e[e] < gymax[:, None, None])
    wodd = inr & ~dup   # weight parity 1  (weights are inr + dup <= 2)
    wpos = inr          # weight >= 1

    tot_par = (wodd.sum(-1) & 1) == 1                               # [N, H]
    rowmax = torch.where(wpos, xi, torch.full_like(xi, -_BIG)).amax(-1)

    # le parity: an edge counts at column c when its bucket
    # t = ceil(xi + 0.5) <= c (t < 0 clamps to bucket 0).
    tf = torch.ceil(xi + 0.5)
    t_ok = wodd & (tf <= wc - 1)
    t_i = tf.clamp(0, wc - 1).to(torch.int64)
    le = torch.zeros(xi.shape[:2] + (wc,), dtype=torch.int32, device=dev)
    le.scatter_add_(-1, t_i, t_ok.to(torch.int32))
    le_par = (le.cumsum(-1) & 1) == 1                            # [N, H, W]

    # Window occupancy: bucket s = floor(xi + 0.5); exact halves belong to
    # no window. A weight-2 bottom-duplicate edge occupies its bucket twice.
    sf = torch.floor(xi + 0.5)
    s_half = xi + 0.5 == sf
    s_ok = wpos & ~s_half & (sf >= 0) & (sf <= wc - 1)
    s_i = sf.clamp(0, wc - 1).to(torch.int64)
    occ = torch.zeros_like(le)
    occ.scatter_add_(-1, s_i, s_ok.to(torch.int32) * (1 + dup.to(torch.int32)))

    # Odd-count trim: dropping one instance of the row max flips le's
    # parity where the max counted, and raises the window threshold to two
    # occupants in the max's own window.
    rm = rowmax[..., None]
    tp = tot_par[..., None]
    trimle = tp & (rm <= cols - 0.5)
    trimwin = tp & (rm > cols - 0.5) & (rm < cols + 0.5)
    fill = (le_par ^ trimle) | (occ >= torch.where(trimwin, 2, 1))

    # --- horizontal edges and wedges ----------------------------------- #
    # Both are closed integer column intervals on a vertex row; a pixel is
    # filled when any of them covers it.
    wact, wlo, whi = wedge_intervals(x0, y0, valid, count, gymax)
    frow = torch.cat([torch.where(horiz, y0, torch.full_like(y0, -_BIG)),
                      torch.where(wact, y0, torch.full_like(y0, -_BIG))], -1)
    flo = torch.cat([torch.minimum(x0, x1), wlo], -1)
    fhi = torch.cat([torch.maximum(x0, x1), whi], -1)
    rowhit = (rows == frow[:, None, :]).to(torch.float32)       # [N, H, F]
    colhit = ((cols >= flo[..., None])
              & (cols <= fhi[..., None])).to(torch.float32)    # [N, F, W]
    # 0/1 operands and sums <= 2V: exact under every matmul precision.
    ffill = torch.bmm(rowhit, colhit) > 0
    return fill | ffill


def _centroid_polygon_mask(verts_c, count, hc: int, wc: int):
    """Even-odd crossing test at pixel centers (PIL orientation)."""
    del count  # padding keeps the closing edge degenerate-safe
    dev = verts_c.device
    px = torch.arange(wc, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(hc, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    points = torch.stack([gx, gy], dim=-1)  # [H, W, 2]
    return geometry.points_in_polygons(
        verts_c[:, None, None], points[None])


def sprite_colors(factors, color_to_rgb: Optional[Callable]):
    """u8-truncated sprite colors as float [..., K, 3] (color_maps.py:28)."""
    colors = factors[..., 5:8]
    if color_to_rgb is not None:
        colors = color_to_rgb(colors)
    return colors.clamp(0, 255).to(torch.uint8).to(torch.float32)


def one_scene(batch_fn: Callable) -> Callable:
    """`render_rgb(factors, num_sprites, **kwargs)` of one scene over a
    module's `render_rgb_batch` (`batch_fn`): factors[K, 10] with
    num_sprites (an int or i32[]) -> u8[H, W, 3], the batch of one, so it
    runs what a batch runs."""

    def render_rgb(factors: torch.Tensor, num_sprites,
                   **kwargs) -> torch.Tensor:
        num = torch.as_tensor(num_sprites, dtype=torch.int32,
                              device=factors.device)
        return batch_fn(factors[None], num[None], **kwargs)[0]

    render_rgb.__doc__ = (f"Render one scene: `{batch_fn.__module__}."
                          f"{batch_fn.__name__}` at B=1 (see `one_scene`).")
    return render_rgb


def render_rgb_batch(factors: torch.Tensor,
                     num_sprites: torch.Tensor,
                     *,
                     image_size: Tuple[int, int] = (64, 64),
                     anti_aliasing: int = 1,
                     bg_color: Optional[Tuple[int, int, int]] = None,
                     color_to_rgb: Optional[Callable] = None,
                     pil_exact: bool = True,
                     downsample: str = "auto") -> torch.Tensor:
    """Render scenes factors[B, K, 10] to u8[B, H, W, 3] (math orientation).

    downsample: "lanczos" reproduces PIL's resize(ANTIALIAS) exactly; "box"
    is the plain average. "auto" follows pil_exact.
    """
    if downsample == "auto":
        downsample = "lanczos" if pil_exact else "box"
    chunks = [
        _render_chunk(factors[s:s + _SCENE_CHUNK],
                      num_sprites[s:s + _SCENE_CHUNK], image_size,
                      int(anti_aliasing), bg_color, color_to_rgb, pil_exact,
                      downsample)
        for s in range(0, factors.shape[0], _SCENE_CHUNK)]
    if not chunks:
        h, w = image_size
        return torch.zeros((0, h, w, 3), dtype=torch.uint8,
                           device=factors.device)
    return torch.cat(chunks, 0)


render_rgb = one_scene(render_rgb_batch)


def _render_chunk(factors, num_sprites, image_size, aa, bg_color,
                  color_to_rgb, pil_exact, downsample):
    h, w = image_size
    hc, wc = h * aa, w * aa
    b, k, _ = factors.shape
    dev = factors.device

    verts_c = _canvas_vertices(factors, hc, wc)  # [B, K, V, 2]
    shape_ids = factors[..., state_lib.SHAPE].to(torch.int64)
    counts = device_lib.constant(constants.VERTEX_COUNTS, dev)[shape_ids]
    colors = sprite_colors(factors, color_to_rgb)

    bg = device_lib.constant(np.array(
        bg_color if bg_color is not None else (0, 0, 0), np.float32), dev)
    canvas = bg.expand(b, hc, wc, 3)

    mask_fn = _pil_polygon_mask if pil_exact else _centroid_polygon_mask
    # Painter's algorithm: ascending slot index paints over (z-order).
    for i in range(k):
        inside = mask_fn(verts_c[:, i], counts[:, i], hc, wc)
        live = (i < num_sprites)[:, None, None]
        canvas = torch.where((inside & live)[..., None],
                             colors[:, i, None, None, :], canvas)

    if aa > 1:
        if downsample == "lanczos":
            out = resample.pil_resize_lanczos(canvas, h, w)
        else:
            out = box_filter(canvas, h, w)
    else:
        out = torch.round(canvas).to(torch.uint8)
    # PIL top-left origin -> math bottom-left origin.
    return torch.flip(out, dims=(1,))


def box_filter(pix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The box filter of integer-valued pixels [B, h*aa, w*aa, 3] ->
    u8[B, h, w, 3]: each channel's exact sum over its aa x aa block, one
    correctly rounded division by aa * aa, rounded half to even (the CUDA
    kernels' `box_words`). The divisor is a tensor: torch divides by a
    scalar through its reciprocal on the card, which rounds differently
    where aa * aa is not a power of two."""
    b, hc, wc, _ = pix.shape
    aa = hc // h
    sums = pix.reshape(b, h, aa, w, aa, 3).sum((2, 4)).to(torch.float32)
    return torch.round(sums / torch.full_like(sums, aa * aa)).to(torch.uint8)
