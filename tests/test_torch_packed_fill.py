"""The packed (anti_aliasing=1) kernel's row fill on the CPU, and the
vertex trig every kernel's tables come from.

csrc/packed_raster.cu fills a canvas row as a 64-bit mask: edges walked in
order with the first row maximum held aside for the odd-total trim,
crossings turned into exact integer column thresholds, parities and
windows as masks, features as precomputed column masks. Its torch twin
`rasterize_cuda.packed_row_masks` repeats that arithmetic; here it is held
bit for bit against `render_rgb_batch_plain` (which the kernel is held
against on the card) on random and adversarial scenes, in both fills and
at canvases 1 to 64 pixels wide, and against the JAX package's packed
kernel in interpret mode. Inputs come from numpy seeds or are written out.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from PIL import Image, ImageDraw

from spriteworld_tpu.ops import rasterize_pallas as jpallas

import chip_smoke

from spriteworld_torch import constants as tconstants
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import geometry as tgeometry
from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda

H100_SMEM_PER_SM = 228 * 1024  # of which 1 KiB is reserved per block


def _twin_image(tables, image_size, bg_color=None):
    """u8[B, H, W, 3]: the scenes painted back to front from the twin's row
    masks, coloured and flipped as the kernel writes them."""
    b, k, _ = tables.tab.shape
    cols = torch.arange(tables.wc)
    slots = torch.zeros((b, tables.hc, tables.wc), dtype=torch.int64)
    for i in range(k):
        bits = ((tcuda.packed_row_masks(tables, i)[..., None] >> cols) & 1)
        slots = torch.where(bits == 1, i + 1, slots)
    packed = torch.cat([
        torch.full((b, 1), float(tcuda._bg_packed(bg_color))),
        tables.tab[..., tcuda.T_COLOR]], -1).to(torch.int64)
    rgb = torch.stack([packed >> 16, (packed >> 8) & 255, packed & 255], -1)
    pix = rgb.gather(1, slots.reshape(b, -1, 1).expand(-1, -1, 3))
    pix = pix.reshape(b, tables.hc, tables.wc, 3).to(torch.uint8)
    return torch.flip(pix, dims=(1,))


def _assert_twin_equals_plain(f, n, size, pil_exact, bg_color=None):
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), size[0],
                           size[1], None, pil_exact)
    got = _twin_image(tables, size, bg_color)
    want = tcuda.render_rgb_batch_plain(tables, size, bg_color)
    assert torch.equal(got, want)
    assert (want != torch.tensor(bg_color or (0, 0, 0),
                                 dtype=torch.uint8)).any()


@pytest.mark.parametrize("pil_exact", [True, False])
@pytest.mark.parametrize("size", [(64, 64), (48, 48), (24, 16), (40, 1)],
                         ids=["w64", "w48", "w16", "w1"])
def test_twin_equals_plain_on_random_scenes(size, pil_exact):
    """Random sprites at every angle, tiny degenerate ones, and 16 sprites
    a scene (K + 1 = 17 slots), at widths 64, 48, 16 and 1."""
    w = size[1]
    for seed, kw in ((w, {}), (w + 1, {"degenerate": True}),
                     (w + 2, {"kmax": 16})):
        f, n = chip_smoke.scene_batch(seed, 12, **kw)
        _assert_twin_equals_plain(f, n, size, pil_exact, (10, 20, 30))


def _regular(cx, cy, r, count, phase=0.0, inner=None):
    """A regular polygon (a star when `inner` is given: every other vertex
    at radius `inner`) of `count` vertices around (cx, cy)."""
    a = phase + 2 * np.pi * np.arange(count) / count
    rad = np.where(np.arange(count) % 2 == 1, inner or r, r)
    return np.stack([cx + rad * np.cos(a), cy + rad * np.sin(a)], -1)


# Canvas-space polygons (x right, y down, 64 x 64), each one scene's
# sprites, back to front.
_CRAFTED = [
    # Half-integer vertices: crossings on pixel boundaries and centres,
    # horizontal edges on interior rows.
    [[(10.5, 10.5), (20.5, 10.5), (20.5, 20.5), (10.5, 20.5)],
     [(15.5, 5.5), (30.5, 12.5), (15.5, 19.5)]],
    # Slopes of 1/2 and 3/2 from integer vertices: crossings at x.5 exactly.
    [[(30, 5), (40, 25), (20, 25)], [(5, 30), (8, 32), (2, 40)],
     [(40, 40), (43, 42), (46, 40), (49, 42), (52, 40), (52, 50)]],
    # Wedges and odd totals: stars with sharp vertices, a zigzag.
    [_regular(32, 32, 20, 10, 0.1, 6), _regular(20, 44, 9, 12, 0.0, 2.5),
     [(2, 2), (12, 8), (22, 2), (32, 8), (42, 2), (42, 14), (22, 14),
      (2, 14)]],
    # Degenerate: a point, a segment, collinear vertices, a sliver.
    [[(5, 5)] * 4, [(0, 0), (10, 10), (20, 20)],
     [(30, 30), (40, 30), (50, 30)], [(10, 50), (40, 50.9), (10, 51.2)]],
    # Past every edge of the canvas, and a circle at fractional centre.
    [_regular(-3, 60, 8, 6), _regular(70, 10, 12, 8), _regular(32, -5, 9, 5),
     _regular(32.5, 32.25, 12.3, 30)],
]


def _crafted_scenes():
    """(factors f32[B, K, 10], live counts, canvas vertices f32[B, K, 30, 2])
    for _CRAFTED, each polygon under the shape id of its vertex count, and
    its padding slots repeating vertex 0 (as the shape bank does)."""
    shape_of = {int(c): s for s, c in enumerate(tconstants.VERTEX_COUNTS)
                if s > 0}
    k = max(len(s) for s in _CRAFTED)
    v = tconstants.MAX_VERTICES
    f = np.tile(tstate.DEFAULT_FACTORS, (len(_CRAFTED), k, 1)).astype(
        np.float32)
    verts = np.zeros((len(_CRAFTED), k, v, 2), np.float32)
    rng = np.random.default_rng(0)
    for b, scene in enumerate(_CRAFTED):
        for i, poly in enumerate(scene):
            poly = np.asarray(poly, np.float32)
            f[b, i, tstate.SHAPE] = shape_of[len(poly)]
            f[b, i, 5:8] = rng.integers(30, 256, 3)
            verts[b, i] = poly[0]
            verts[b, i, :len(poly)] = poly
    n = np.array([len(s) for s in _CRAFTED], np.int32)
    return f, n, verts


@pytest.mark.parametrize("pil_exact", [True, False])
def test_twin_equals_plain_on_crafted_polygons(pil_exact, monkeypatch):
    """Vertices on half-integers, horizontal edges on interior rows,
    crossings on pixel boundaries, wedges, degenerate sprites and sprites
    past the canvas: the tables come from these canvas vertices."""
    f, n, verts = _crafted_scenes()
    monkeypatch.setattr(trasterize, "_canvas_vertices",
                        lambda *_: torch.from_numpy(verts))
    _assert_twin_equals_plain(f, n, (64, 64), pil_exact)
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), 64, 64,
                           None, pil_exact)
    if pil_exact:  # the crafted rows reach the trim and the features
        assert int(tables.tab[..., tcuda.T_NF].sum()) > 10
        xi, _ = tcuda.exact_crossings(tables, 1)
        assert (xi.frac().abs() == 0.5).any()


@pytest.mark.parametrize("pil_exact", [True, False])
def test_row_masks_do_not_depend_on_edge_order(pil_exact):
    """The kernel walks each row's crossing edges in the order they were
    listed, which varies: the masks depend only on the crossings and their
    weights (the trim takes one unit off the row maximum, whichever edge
    holds it), so any order of the edges gives the same masks."""
    f, n = chip_smoke.scene_batch(91, 16, kmax=6)
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), 48, 48,
                           None, pil_exact)
    v = tables.num_vertices
    perm = torch.from_numpy(np.random.default_rng(0).permutation(v))
    tab = tables.tab.clone()
    for fld in range(tcuda.NUM_EDGE_FIELDS):
        block = slice(tcuda.NUM_SCALARS + fld * v,
                      tcuda.NUM_SCALARS + (fld + 1) * v)
        tab[..., block] = tables.tab[..., block][..., perm]
    shuffled = tcuda.SceneTables(tab=tab, num_vertices=v, hc=48, wc=48,
                                 pil_exact=pil_exact)
    for k in range(6):
        assert torch.equal(tcuda.packed_row_masks(shuffled, k),
                           tcuda.packed_row_masks(tables, k))


def test_twin_thresholds_at_pixel_boundaries():
    """One exact crossing at x: the parity covers the columns c with
    x <= c - 0.5, the window the column c with c - 0.5 < x < c + 0.5,
    none on a boundary; far crossings clamp."""
    xs = torch.tensor([3.5, 3.25, 3.75, 4.0, -0.5, -7.0, 63.5, 70.0,
                       np.nextafter(np.float32(3.5), np.float32(0))])
    zero = torch.zeros(len(xs), dtype=torch.int64)
    parity, window = tcuda._fold(xs, zero + 1, zero, zero)
    for x, p, win in zip(xs.tolist(), parity.tolist(), window.tolist()):
        cols = [c for c in range(64) if (p >> c) & 1]
        assert cols == [c for c in range(64) if x <= c - 0.5]
        wcols = [c for c in range(64) if (win >> c) & 1]
        assert wcols == [c for c in range(64) if c - 0.5 < x < c + 0.5]
    parity, window = tcuda._fold(xs, zero + 2, zero, zero)
    assert not parity.any() and window.any()


@functools.lru_cache(maxsize=None)
def _jax_packed(pil_exact):
    return functools.partial(jpallas.render_rgb_batch, interpret=True,
                             image_size=(32, 32), anti_aliasing=1,
                             pil_exact=pil_exact)


def _pillow(f, n, hc, wc):
    """Pillow's exact fill on the port's vertices, flipped: u8[B, hc, wc,
    3]."""
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * torch.tensor([wc, hc], dtype=torch.float32)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    out = []
    for b in range(len(f)):
        im = Image.new("RGB", (wc, hc))
        draw = ImageDraw.Draw(im)
        for k in range(n[b]):
            pts = [tuple(int(c) for c in p)
                   for p in np.trunc(verts[b, k, :counts[b, k]])]
            draw.polygon(pts, fill=tuple(int(c) for c in f[b, k, 5:8]))
        out.append(np.asarray(im)[::-1])
    return np.stack(out)


@pytest.mark.parametrize("pil_exact", [True, False])
def test_twin_matches_jax_packed_mode(pil_exact):
    """The twin against the JAX package's packed kernel (interpret mode) at
    32x32/AA=1: the exact fill wherever JAX equals Pillow (XLA on the CPU
    may contract the crossing into an FMA), the centroid fill away from
    centres within 1e-3 pixels of a crossing (JAX crosses as
    x0 + (row - y0) * m, the port as points_in_polygons does)."""
    assert tcuda.uses_packed((32, 32), 1, "auto")
    f, n = chip_smoke.scene_batch(81 + pil_exact, 4, kmax=6)
    want = np.asarray(_jax_packed(pil_exact)(jnp.asarray(f), jnp.asarray(n)))
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), 32, 32,
                           None, pil_exact)
    got = _twin_image(tables, (32, 32)).numpy()
    differ = (got != want).any(-1)
    if pil_exact:
        pil = _pillow(f, n, 32, 32)
        agree = (want == pil).all(-1)
        assert agree.mean() > 0.999
        assert not (differ & agree).any()
    else:
        verts = (tgeometry.world_vertices(torch.from_numpy(f)).double()
                 * 32).numpy()
        counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
        near = np.zeros(differ.shape, bool)
        c = np.arange(32) + 0.5
        for b in range(len(f)):
            for k in range(n[b]):
                v = verts[b, k, :counts[b, k]]
                x1, y1 = v[:, 0], v[:, 1]
                x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
                st = (y1[None] > c[:, None]) != (y2[None] > c[:, None])
                dy = np.where(y2 == y1, 1.0, y2 - y1)
                xc = x1 + (c[:, None] - y1) / dy * (x2 - x1)
                d = np.abs(c[None, :, None] - xc[:, None, :])
                near[b] |= (st[:, None, :] & (d < 1e-3)).any(-1)[::-1]
        assert not (differ & ~near).any()
    assert got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_centered_vertices_round_float64_trig_once(seed):
    """The radians are the float32 product the JAX package computes; their
    sine and cosine are taken in float64 and rounded once to float32, so
    the card and the CPU agree; the rotation is float32 throughout."""
    rng = np.random.default_rng(seed)
    f = np.tile(tstate.DEFAULT_FACTORS, (512, 1)).astype(np.float32)
    f[:, tstate.SHAPE] = rng.integers(1, 13, 512)
    f[:, tstate.ANGLE] = rng.uniform(0, 360, 512)
    f[:, tstate.ANGLE][:4] = (0.0, 90.0, 180.0, 45.0)
    f[:, tstate.SCALE] = rng.uniform(0.05, 0.3, 512)
    rad = f[:, tstate.ANGLE] * np.float32(np.pi / 180.0)
    c = np.cos(rad.astype(np.float64)).astype(np.float32)[:, None]
    s = np.sin(rad.astype(np.float64)).astype(np.float32)[:, None]
    base = tconstants.VERTEX_BANK[f[:, tstate.SHAPE].astype(int)]
    scaled = base * f[:, tstate.SCALE][:, None, None]
    vx, vy = scaled[..., 0], scaled[..., 1]
    want = np.stack([c * vx - s * vy, s * vx + c * vy], -1)
    got = tgeometry.centered_vertices(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_layout_fits_16_blocks_an_sm():
    """The packed kernel's shared memory at the paths' tables (K = 6, V =
    30, 64 rows: two warps) lets 16 blocks share an H100 SM, the 2048
    scenes of image64 in one wave; 254 sprites stay within one block's
    budget (staged in chunks), and the records' region always holds the
    warps' output buffers."""
    assert [tcuda.packed_threads(r) for r in (1, 16, 33, 64, 512)] == \
        [32, 32, 64, 64, 128]
    small = tcuda.packed_smem_bytes(6, 30, 64)
    assert 16 * (small + 1024) <= H100_SMEM_PER_SM
    assert tcuda.packed_record_words(30, 60) == 120 + 60 + 240
    big = tcuda.packed_smem_bytes(254, 30, 512)
    assert big == (1024 + tcuda._round16((13 * 254 + 3) * 4)
                   + 4 * max(tcuda._PACKED_STAGE_WORDS,
                             4 * tcuda._PACKED_OUT_WORDS))
    assert big < 64 * 1024
    one = tcuda.packed_smem_bytes(1, 3, 512)  # the buffers of four warps
    assert one - 16 - 64 == 4 * tcuda._PACKED_OUT_WORDS * 4


@pytest.mark.parametrize("h", [1, 16, 48, 64, 128, 256, 384, 15872])
def test_packed_tiles_take_one_pass(h):
    """A packed_raster block renders its tile in one pass, a lane a row:
    tiles hold the whole frame up to 128 rows, and no tile has more rows
    than its block has threads."""
    rows = tcuda.default_tile_rows(h)
    assert rows == min(h, 128)
    assert rows <= tcuda.packed_threads(rows)
    assert -(-h // rows) * rows >= h
