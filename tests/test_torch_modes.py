"""Port parity, the kernels' other modes: the centroid fill, the box filter
and the anti_aliasing=1 small-canvas (packed) dispatch.

Inputs are made with numpy from a seed and fed to the JAX package and to
the port's plain twin (`rasterize_cuda.render_rgb_batch` on CPU tensors,
which every kernel is held against on the card). Tolerances: exact at
anti_aliasing=1; +-1 above it, where the JAX box filter multiplies by 1/aa
in float32 and the port divides integer sums once. Where the JAX package on
the CPU could differ by an FMA (XLA contracts the centroid crossing's
multiply-add), a float64 recomputation of the crossing decides, and for the
exact fill Pillow does.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image, ImageDraw

from spriteworld_tpu.ops import rasterize as jrasterize
from spriteworld_tpu.ops import rasterize_pallas as jpallas

from spriteworld_torch import constants as tconstants
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import geometry as tgeometry
from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda


def _sprites(rng, b, k, scale=(0.08, 0.3)):
    f = np.tile(tstate.DEFAULT_FACTORS, (b, k, 1)).astype(np.float32)
    f[..., tstate.X] = rng.uniform(0.1, 0.9, (b, k))
    f[..., tstate.Y] = rng.uniform(0.1, 0.9, (b, k))
    f[..., tstate.SHAPE] = rng.integers(1, 13, (b, k))
    f[..., tstate.ANGLE] = rng.uniform(0, 360, (b, k))
    f[..., tstate.SCALE] = rng.uniform(*scale, (b, k))
    f[..., 5:8] = rng.integers(30, 256, (b, k, 3))
    n = rng.integers(1, k + 1, b).astype(np.int32)
    return f, n


@functools.lru_cache(maxsize=None)
def _jax_render(**kwargs):
    return jax.jit(jax.vmap(
        lambda f, n: jrasterize.render_rgb(f, n, **kwargs)))


def _port(f, n, **kwargs):
    return tcuda.render_rgb_batch(torch.from_numpy(f), torch.from_numpy(n),
                                  **kwargs).numpy()


def _near_crossing(f, n, hc, wc, tol=1e-4):
    """bool[B, hc, wc] (Pillow's row order): pixel centres within `tol`
    canvas pixels of an edge crossing of a live sprite, in float64 — where
    one float32 rounding more or less can flip the centroid test."""
    verts = (tgeometry.world_vertices(torch.from_numpy(f)).double()
             * torch.tensor([wc, hc], dtype=torch.float64)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    py = np.arange(hc) + 0.5
    px = np.arange(wc) + 0.5
    out = np.zeros((len(f), hc, wc), bool)
    for b in range(len(f)):
        for k in range(n[b]):
            v = verts[b, k, :counts[b, k]]
            x1, y1 = v[:, 0], v[:, 1]
            x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
            st = (y1[None] > py[:, None]) != (y2[None] > py[:, None])
            dy = np.where(y2 == y1, 1.0, y2 - y1)
            xc = x1 + (py[:, None] - y1) / dy * (x2 - x1)  # [hc, V]
            d = np.abs(px[None, :, None] - xc[:, None, :])  # [hc, wc, V]
            out[b] |= (st[:, None, :] & (d < tol)).any(-1)
    return out


@pytest.mark.parametrize("size,aa,downsample", [
    (32, 1, "auto"), (32, 2, "auto"), (64, 5, "box")])
def test_centroid_twin_matches_jax(size, aa, downsample):
    """The centroid tables and the twin against JAX render_rgb(pil_exact=
    False): exact at AA=1 away from float64-ambiguous pixel centres, +-1
    above."""
    rng = np.random.default_rng(size + aa)
    f, n = _sprites(rng, 4, 6)
    kw = dict(image_size=(size, size), anti_aliasing=aa, pil_exact=False,
              downsample=downsample)
    got = _port(f, n, **kw).astype(int)
    want = np.asarray(_jax_render(**kw)(f, n)).astype(int)
    assert got.any()
    if aa == 1:
        differ = (got != want).any(-1)
        ambiguous = _near_crossing(f, n, size, size)[:, ::-1]
        assert not (differ & ~ambiguous).any()
        assert differ.sum() <= 2
    else:
        assert np.abs(got - want).max() <= 1


def _pillow_canvas(f, n, hc, wc):
    """Pillow's exact fill of each scene on the port's vertices:
    u8[B, hc, wc, 3] in Pillow's row order."""
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * torch.tensor([wc, hc], dtype=torch.float32)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    out = []
    for b in range(len(f)):
        im = Image.new("RGB", (wc, hc), (0, 0, 0))
        draw = ImageDraw.Draw(im)
        for k in range(n[b]):
            pts = [tuple(int(c) for c in p)
                   for p in np.trunc(verts[b, k, :counts[b, k]])]
            draw.polygon(pts, fill=tuple(int(c) for c in f[b, k, 5:8]))
        out.append(np.asarray(im))
    return np.stack(out)


def test_exact_box_matches_pillow_and_jax():
    """Exact fill + box filter: equal to Pillow's fill box-averaged with one
    division per sum (rounded half to even), and within +-1 of JAX."""
    rng = np.random.default_rng(7)
    f, n = _sprites(rng, 3, 6)
    kw = dict(image_size=(24, 24), anti_aliasing=5, downsample="box")
    got = _port(f, n, **kw)
    canvas = _pillow_canvas(f, n, 120, 120).astype(np.int64)
    sums = canvas.reshape(3, 24, 5, 24, 5, 3).sum((2, 4))
    box = np.round(sums.astype(np.float32) / np.float32(25)).astype(np.uint8)
    np.testing.assert_array_equal(got, box[:, ::-1])
    want = np.asarray(_jax_render(**kw)(f, n)).astype(int)
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("aa", [2, 3, 6])
def test_box_twin_divides_once(aa):
    """The twin's box filter is sum / (aa * aa) correctly rounded, then
    half to even — also where aa * aa is not a power of two and a sum lands
    on a half (a multiply by the reciprocal would round some of those
    otherwise)."""
    rng = np.random.default_rng(aa)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 4 * aa, 4 * aa, 3)))
    got = trasterize.box_filter(pix, 4, 4).numpy()
    sums = pix.numpy().reshape(2, 4, aa, 4, aa, 3).sum((2, 4))
    want = np.round(sums.astype(np.float32) / np.float32(aa * aa))
    np.testing.assert_array_equal(got, want.astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _jax_pallas(**kwargs):
    return functools.partial(jpallas.render_rgb_batch, interpret=True,
                             **kwargs)


@pytest.mark.parametrize("pil_exact", [True, False])
def test_packed_mode_matches_pallas_interpret(pil_exact):
    """The twin against the JAX packed kernel (interpret mode) at
    64x64/AA=1: exact, away from float64-ambiguous centres for the centroid
    fill (the TPU kernel crosses as x0 + (row - y0) * m, ops/geometry.py as
    x1 + t * (x2 - x1))."""
    assert tcuda.uses_packed((64, 64), 1, "auto")
    rng = np.random.default_rng(11 + pil_exact)
    f, n = _sprites(rng, 3, 6)
    kw = dict(image_size=(64, 64), anti_aliasing=1, pil_exact=pil_exact)
    want = np.asarray(_jax_pallas(**kw)(jnp.asarray(f), jnp.asarray(n)))
    got = _port(f, n, **kw)
    if pil_exact:
        np.testing.assert_array_equal(got, want)
    else:
        differ = (got != want).any(-1)
        ambiguous = _near_crossing(f, n, 64, 64, tol=1e-3)[:, ::-1]
        assert not (differ & ~ambiguous).any()
        assert differ.sum() <= 3
    assert got.any()


def test_strips_box_matches_pallas_interpret():
    """The twin against the JAX strip kernel (interpret mode) in centroid +
    box at 32x32/AA=2: +-1 (the TPU kernel averages through 1/aa matrices
    in float32)."""
    rng = np.random.default_rng(13)
    f, n = _sprites(rng, 2, 5)
    kw = dict(image_size=(32, 32), anti_aliasing=2, pil_exact=False)
    want = np.asarray(_jax_pallas(kernel_mode="strips", strip_limit=512,
                                  **kw)(jnp.asarray(f), jnp.asarray(n)))
    got = _port(f, n, kernel_mode="strips", **kw)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.any()


def _jax_packed_rule(h, w, aa, kernel_mode):
    """rasterize_pallas.render_rgb_batch's packed condition, spelled out
    from its own `_pick_strip`."""
    hc, wc = h * aa, w * aa
    num_strips = hc // (jpallas._pick_strip(h, aa, wc, 16000) * aa)
    return (aa == 1 and num_strips == 1 and wc < 128 and 128 % wc == 0
            and (hc * wc) % 128 == 0 and kernel_mode != "scene")


def test_packed_rule_equals_jax():
    sizes = [1, 2, 4, 6, 8, 10, 16, 24, 30, 32, 48, 64, 96, 100, 128, 250,
             256, 300, 512]
    seen = 0
    for h in sizes:
        for w in sizes:
            for aa in (1, 2, 5):
                for mode in tcuda.KERNEL_MODES:
                    want = _jax_packed_rule(h, w, aa, mode)
                    assert tcuda.uses_packed((h, w), aa, mode) == want, (
                        h, w, aa, mode)
                    seen += want
    assert seen > 50


def test_scene_layout_in_box_mode():
    """The box filter needs no taps and no h-pass buffer: its layout holds,
    for each of its 16 warps, one group of anti_aliasing canvas rows of wc
    rounded up to 16 bytes (a warp renders whole output rows from its own
    group), then the channel tables of its mixed blocks' sums. The identity
    (anti_aliasing=1) holds the whole canvas. The Lanczos layout, for 8
    warps, holds one band of 80 canvas rows at the h-pass tiles' pitch
    beside the h-pass buffer; at 64x64/AA=5 it lets two blocks share an
    H100 SM (228 KiB of shared memory, 1 KiB of it reserved per block) and
    the box layout three; 64x64/AA=6 fits one block in either mode."""
    k, v = 6, 30
    box = tcuda.scene_smem_bytes(k, v, 320, 320, 64, 64, tcuda.DS_BOX)
    lanczos = tcuda.scene_smem_bytes(k, v, 320, 320, 64, 64,
                                     tcuda.DS_LANCZOS)
    ident = tcuda.scene_smem_bytes(k, v, 64, 64, 64, 64, tcuda.DS_IDENTITY)
    words = k * tcuda.table_width(v) + k + 1 + 2 * 16 * 32
    head = (words * 4 + 15) & ~15
    assert box == head + 16 * 5 * 320 + 48
    assert ident == head + 64 * 64 + 48
    cp = tcuda.lanczos_tiles(320, 64).pitch
    wp, hp = tcuda.hpass_geometry(320, 64, 64)
    assert (wp, cp, hp) == (64, 336, 336)
    head8 = head - 2 * 8 * 32 * 4  # 8 warps' crossing scratch, not 16
    # The plan of the live units: 6 sprites' bounds (four words each), the
    # count and list of 40 groups of 8 canvas rows, 160 h-pass units (a bit
    # each: 4 m-tiles x 2 words), 32 v-pass units (a word); rounded up to
    # 16 bytes.
    plan = (4 * (4 * 6 + 1 + 40 + 4 * 2 + 1) + 15) & ~15
    assert tcuda.plan_bytes(k, 320, 64, 64) == plan
    assert lanczos == head8 + 80 * cp + 48 + 3 * wp * hp + plan
    assert 2 * (lanczos + 1024) <= 228 * 1024
    assert 3 * (box + 1024) <= 228 * 1024
    budget = 232_448
    aa6 = dict(k=k, num_vertices=v, hc=384, wc=384, h=64, w=64)
    assert tcuda.scene_smem_bytes(**aa6, ds=tcuda.DS_BOX) <= budget
    assert tcuda.scene_smem_bytes(**aa6, ds=tcuda.DS_LANCZOS) <= budget
    assert tcuda.resolve_kernel_mode(
        "auto", tcuda.scene_smem_bytes(**aa6, ds=tcuda.DS_BOX),
        budget) == "scene"
    assert tcuda.downsample_mode(6, False, "auto") == tcuda.DS_BOX
    assert tcuda.downsample_mode(1, True, "lanczos") == tcuda.DS_IDENTITY
    with pytest.raises(ValueError, match="downsample"):
        tcuda.downsample_mode(2, True, "bilinear")


def test_centroid_tables():
    """Centroid tables: no features, untruncated edges as points_in_polygons
    reads them, neutral padding and dead slots, bounds that hold every
    filled pixel; the twin's fill equals ops/rasterize.py's per sprite."""
    rng = np.random.default_rng(17)
    f, _ = _sprites(rng, 2, 4)
    n = np.array([4, 2], np.int32)
    ft, nt = torch.from_numpy(f), torch.from_numpy(n)
    tables = tcuda.prepare(ft, nt, 96, 96, None, pil_exact=False)
    tab = tables.tab
    assert not tables.pil_exact
    assert (tab[..., tcuda.T_NF] == 0).all()
    assert (tables.features() == 0).all()
    v = tables.num_vertices
    edge = lambda fld: tab[..., tcuda.NUM_SCALARS + fld * v:
                           tcuda.NUM_SCALARS + (fld + 1) * v]
    counts = tab[..., tcuda.T_COUNT].long()
    pad = torch.arange(v) >= counts[..., None]
    assert (edge(tcuda.C_Y1)[pad] == edge(tcuda.C_Y0)[pad]).all()
    verts = trasterize._canvas_vertices(ft, 96, 96)
    np.testing.assert_array_equal(edge(tcuda.C_X0).numpy(),
                                  verts[..., 0].numpy())
    for b in range(2):
        for k in range(4):
            fill = tcuda._plain_fill(tables, k)[b]
            if k >= n[b]:
                assert not fill.any()
                continue
            want = trasterize._centroid_polygon_mask(
                verts[b, k][None], None, 96, 96)[0]
            assert torch.equal(fill, want) and fill.any()
