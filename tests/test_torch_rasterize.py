"""Port parity, rasterizer: per-polygon masks, full renders, the scene
kernel's plain version.

Inputs are made with numpy from a seed and fed to the JAX package and to
the PyTorch port on the CPU; Pillow is the independent reference where the
two could legitimately differ.
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
from spriteworld_tpu.utils import colors as jcolors

from spriteworld_torch import constants as tconstants
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import geometry as tgeometry
from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.utils import colors as tcolors


def _sprites(rng, shape, degenerate=False, hsv=False):
    """Factors f32[*shape, 10]: random, or the degenerate generator of
    tests/test_render.py (tiny scales, half axis-aligned angles)."""
    k = shape[-1]
    f = np.tile(tstate.DEFAULT_FACTORS, shape + (1,)).astype(np.float32)
    f[..., tstate.X] = rng.uniform(0.1, 0.9, shape)
    f[..., tstate.Y] = rng.uniform(0.1, 0.9, shape)
    if degenerate:
        f[..., tstate.SHAPE] = rng.choice([3, 8, 9, 10, 11, 12], shape)
        f[..., tstate.ANGLE] = np.where(
            np.arange(k) % 2 == 0, rng.choice([0.0, 90.0, 180.0], shape),
            rng.uniform(0, 360, shape))
        f[..., tstate.SCALE] = rng.uniform(0.02, 0.07, shape)
    else:
        f[..., tstate.SHAPE] = rng.integers(1, 13, shape)
        f[..., tstate.ANGLE] = rng.uniform(0, 360, shape)
        f[..., tstate.SCALE] = rng.uniform(0.05, 0.3, shape)
    if hsv:
        f[..., 5:8] = rng.uniform(0, 1, shape + (3,))
    else:
        f[..., 5:8] = rng.integers(30, 256, shape + (3,))
    return f


@functools.lru_cache(maxsize=None)
def _jax_masks(hc, wc):
    return jax.jit(jax.vmap(
        lambda v, c: jrasterize._pil_polygon_mask(v, c, hc, wc)))


@functools.lru_cache(maxsize=None)
def _jax_render(**kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("hsv", False):
        kwargs["color_to_rgb"] = jcolors.hsv_to_rgb
    return jax.jit(jax.vmap(
        lambda f, n: jrasterize.render_rgb(f, n, **kwargs)))


def _torch_render(f, n, hsv=False, **kwargs):
    if hsv:
        kwargs["color_to_rgb"] = tcolors.hsv_to_rgb
    return trasterize.render_rgb_batch(torch.from_numpy(f),
                                       torch.from_numpy(n), **kwargs).numpy()


def _pillow_mask(verts, hc, wc):
    im = Image.new("L", (wc, hc), 0)
    pts = [tuple(int(c) for c in p) for p in np.trunc(verts)]
    ImageDraw.Draw(im).polygon(pts, fill=1)
    return np.asarray(im).astype(bool)


@pytest.mark.parametrize("canvas", [64, 320])
@pytest.mark.parametrize("degenerate", [False, True])
def test_polygon_mask_matches_pillow_and_jax(canvas, degenerate):
    """Identical canvas vertices into both fills: the port equals Pillow's
    ImageDraw.polygon on every pixel, and the JAX fill on every pixel where
    the JAX fill equals Pillow. (XLA on the CPU contracts the crossing
    x0 + (row - y0) * m into an FMA, which moves a crossing that lands on a
    half-pixel by an ulp; Pillow and the port round the product first.)"""
    rng = np.random.default_rng(canvas + degenerate)
    f = _sprites(rng, (96,), degenerate)
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * torch.tensor([canvas, canvas], dtype=torch.float32)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[:, tstate.SHAPE].astype(int)]
    got = trasterize._pil_polygon_mask(
        torch.from_numpy(verts), torch.from_numpy(counts), canvas,
        canvas).numpy()
    want = np.asarray(_jax_masks(canvas, canvas)(verts, counts))
    pillow = np.stack([_pillow_mask(verts[i, :counts[i]], canvas, canvas)
                       for i in range(len(f))])
    np.testing.assert_array_equal(got, pillow)
    agree = want == pillow
    np.testing.assert_array_equal(got[agree], want[agree])
    assert (~agree).sum() <= 2
    assert got.sum() > 0


@pytest.mark.parametrize("case", [
    "rgb", "hsv", "bg_color", "dead_slots", "occlusion", "degenerate"])
def test_render_rgb_aa1_bitexact_vs_jax(case):
    rng = np.random.default_rng(len(case))
    b, k = 6, 6
    f = _sprites(rng, (b, k), degenerate=case == "degenerate",
                 hsv=case == "hsv")
    n = np.full(b, k, np.int32)
    kwargs = dict(image_size=(32, 32), anti_aliasing=1)
    if case == "bg_color":
        kwargs["bg_color"] = (10, 20, 30)
    if case == "dead_slots":
        n = rng.integers(0, k + 1, b).astype(np.int32)
    if case == "occlusion":
        f[..., tstate.X] = rng.uniform(0.45, 0.55, (b, k))
        f[..., tstate.Y] = rng.uniform(0.45, 0.55, (b, k))
    hsv = case == "hsv"
    want = np.asarray(_jax_render(hsv=hsv, **kwargs)(f, n))
    got = _torch_render(f, n, hsv=hsv, **kwargs)
    np.testing.assert_array_equal(got, want)
    if case == "dead_slots":
        # A dead slot paints nothing: rendering without it is the same.
        f2 = f.copy()
        f2[np.arange(k)[None, :] >= n[:, None]] = tstate.DEFAULT_FACTORS
        np.testing.assert_array_equal(_torch_render(f2, n, **kwargs), got)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_rgb_aa5_within_one_of_jax(seed):
    """The JAX Lanczos sums in float32; the port's is exact: +-1."""
    rng = np.random.default_rng(10 + seed)
    f = _sprites(rng, (4, 6), hsv=True)
    n = np.array([6, 5, 3, 1], np.int32)
    kwargs = dict(image_size=(24, 24), anti_aliasing=5)
    want = np.asarray(_jax_render(hsv=True, **kwargs)(f, n)).astype(int)
    got = _torch_render(f, n, hsv=True, **kwargs).astype(int)
    assert np.abs(got - want).max() <= 1


def _pillow_scene(verts, counts, colors, n, hc, wc, h, w):
    """The reference PILRenderer pipeline on the port's own vertices."""
    im = Image.new("RGB", (wc, hc), (0, 0, 0))
    draw = ImageDraw.Draw(im)
    for i in range(n):
        pts = [tuple(int(c) for c in p) for p in np.trunc(verts[i, :counts[i]])]
        draw.polygon(pts, fill=tuple(int(c) for c in colors[i]))
    out = im.resize((w, h), resample=Image.LANCZOS) if hc != h else im
    return np.asarray(out)[::-1]


@pytest.mark.parametrize("aa", [1, 2, 5])
def test_render_rgb_bitexact_vs_pillow(aa):
    """The full port render equals Pillow's draw + resize(LANCZOS) + flip on
    the same vertices, at every anti_aliasing."""
    rng = np.random.default_rng(20 + aa)
    b, k, h = 3, 6, 48
    f = _sprites(rng, (b, k))
    n = np.array([6, 4, 2], np.int32)
    got = _torch_render(f, n, image_size=(h, h), anti_aliasing=aa)
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * float(h * aa)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    colors = f[..., 5:8].astype(np.uint8)
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], _pillow_scene(verts[i], counts[i], colors[i], n[i],
                                  h * aa, h * aa, h, h))


@functools.lru_cache(maxsize=None)
def _jax_scene_kernel(**kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("hsv", False):
        kwargs["color_to_rgb"] = jcolors.hsv_to_rgb
    return functools.partial(jpallas.render_rgb_batch, interpret=True,
                             kernel_mode="scene", **kwargs)


@pytest.mark.parametrize("size,aa,degenerate,hsv", [
    (32, 2, False, False), (32, 2, True, False), (64, 1, False, False),
    (64, 1, True, True)])
def test_scene_plain_matches_pallas_interpret(size, aa, degenerate, hsv):
    """The kernel's plain version against the JAX scene kernel, run as the
    JAX package's own tests run it on the CPU: exact at AA=1, +-1 above
    (the Pallas kernel splits its Lanczos taps into bf16 halves). Where
    the JAX kernel's fill is not Pillow's (it leaves column 0 out of a
    span that ends at -0.5), the image is Pillow's, bit for bit."""
    rng = np.random.default_rng(size + aa + degenerate)
    f = _sprites(rng, (4, 8), degenerate=degenerate, hsv=hsv)
    n = rng.integers(1, 9, 4).astype(np.int32)
    kwargs = dict(image_size=(size, size), anti_aliasing=aa)
    want = np.asarray(_jax_scene_kernel(hsv=hsv, **kwargs)(
        jnp.asarray(f), jnp.asarray(n))).astype(int)
    got = tcuda.render_rgb_batch(
        torch.from_numpy(f), torch.from_numpy(n),
        color_to_rgb=tcolors.hsv_to_rgb if hsv else None,
        **kwargs).numpy().astype(int)
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * float(size * aa)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    colors = (tcolors.hsv_to_rgb(torch.from_numpy(f[..., 5:8])).numpy()
              if hsv else f[..., 5:8]).astype(np.uint8)
    tol = 0 if aa == 1 else 1
    for i in range(len(f)):
        pil = _pillow_scene(verts[i], counts[i], colors[i], n[i], size * aa,
                            size * aa, size, size).astype(int)
        if np.abs(want[i] - pil).max() <= tol:
            assert np.abs(got[i] - want[i]).max() <= tol, i
        else:
            np.testing.assert_array_equal(got[i], pil)


def _edge_sprites(rng, n):
    """f32[n, 1, 10]: one sprite of each shape in turn whose centre lies
    within 0.08 of the left or the right frame edge, integer or uniform
    angles, scales 0.05-0.3."""
    f = np.zeros((n, 1, 10), np.float32)
    left = rng.random(n) < 0.5
    f[:, 0, 0] = np.where(left, rng.uniform(-0.08, 0.08, n),
                          rng.uniform(0.92, 1.08, n))
    f[:, 0, 1] = rng.uniform(-0.05, 1.05, n)
    f[:, 0, 2] = np.arange(n) % 12 + 1
    f[:, 0, 3] = np.where(rng.random(n) < 0.5, rng.integers(0, 360, n),
                          rng.uniform(0, 360, n))
    f[:, 0, 4] = rng.uniform(0.05, 0.3, n)
    return f


def test_every_plain_fill_equals_pillow_at_the_frame_edges():
    """Sprites across the left and right edges of a 64x64 canvas: the fill
    of ops/rasterize.py, the tables' exact fill and the packed kernel's
    row masks each equal Pillow's, pixel for pixel. Pillow rounds a
    negative half away from zero, so a span that ends at -0.5 ends at
    column 0, and so does a wedge whose end rounds from -0.5."""
    rng = np.random.default_rng(3)
    n, size = 1200, 64
    f = _edge_sprites(rng, n)
    ft, num = torch.from_numpy(f), torch.ones(n, dtype=torch.int32)
    counts = tconstants.VERTEX_COUNTS[f[:, 0, tstate.SHAPE].astype(int)]
    verts = (tgeometry.world_vertices(ft)[:, 0] * float(size)).numpy()
    pil = np.zeros((n, size, size), bool)
    for i in range(n):
        im = Image.new("L", (size, size), 0)
        ImageDraw.Draw(im).polygon(
            [tuple(int(c) for c in p) for p in np.trunc(verts[i, :counts[i]])],
            fill=255)
        pil[i] = np.asarray(im) > 0
    tables = tcuda.prepare(ft, num, size, size, None, True)
    masks = tcuda.packed_row_masks(tables, 0).numpy()
    fills = {
        "rasterize": trasterize._pil_polygon_mask(
            torch.from_numpy(verts), torch.from_numpy(counts), size,
            size).numpy(),
        "tables": tcuda._plain_fill_exact(tables, 0).numpy(),
        "packed": ((masks[..., None] >> np.arange(size)) & 1).astype(bool)}
    for name, fill in fills.items():
        off = np.flatnonzero((fill != pil).any((1, 2)))
        assert len(off) == 0, (name, off[:5])
    xi, wgt = tcuda.exact_crossings(tables, 0)  # -0.5 counted as above it
    assert ((xi == trasterize.ABOVE_NEG_HALF) & (wgt > 0)).any()


@pytest.mark.parametrize("aa", [1, 2, 5])
@pytest.mark.parametrize("degenerate", [False, True])
def test_scene_plain_matches_plain_rasterizer(aa, degenerate):
    """Two independent fills of the port — the scene kernel's plain version
    (exact float64 buckets over prepared tables) and ops/rasterize.py (the
    XLA rasterizer's float32 bucket form) — agree exactly."""
    rng = np.random.default_rng(30 + aa + degenerate)
    f = _sprites(rng, (4, 7), degenerate=degenerate)
    n = rng.integers(0, 8, 4).astype(np.int32)
    kwargs = dict(image_size=(32, 32), anti_aliasing=aa, bg_color=(5, 6, 7))
    got = tcuda.render_rgb_batch(torch.from_numpy(f), torch.from_numpy(n),
                                 **kwargs).numpy()
    np.testing.assert_array_equal(got, _torch_render(f, n, **kwargs))


def test_prepare_tables():
    """Dead slots are neutral; features are compacted; bounds hold every
    filled pixel."""
    rng = np.random.default_rng(40)
    f = _sprites(rng, (3, 5), degenerate=True)
    n = np.array([5, 2, 0], np.int32)
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), 64, 64,
                           None)
    tab = tables.tab
    assert tab.shape == (3, 5, tcuda.table_width(30))
    counts = tab[..., tcuda.T_COUNT]
    assert (counts[1, 2:] == 0).all() and (counts[2] == 0).all()
    assert (counts[0] > 0).all()
    feats = tables.features()
    nf = tab[..., tcuda.T_NF].long()
    for b in range(3):
        for k in range(5):
            assert (feats[b, k, nf[b, k]:] == 0).all()
    for k in range(5):
        fill = tcuda._plain_fill(tables, k)[0]
        rows, cols = torch.nonzero(fill, as_tuple=True)
        t = tab[0, k]
        assert rows.numel() > 0
        assert rows.min() >= t[tcuda.T_ROW0] and rows.max() <= t[tcuda.T_ROW1]
        assert cols.min() >= t[tcuda.T_COL0] and cols.max() <= t[tcuda.T_COL1]


def test_scene_kernel_modes_and_devices():
    """The centroid fill and the box filter render on CPU tensors through
    the plain twin, which equals ops/rasterize.render_rgb; the kernel
    wrappers refuse CPU tables."""
    f = torch.from_numpy(_sprites(np.random.default_rng(0), (1, 2)))
    n = torch.tensor([2], dtype=torch.int32)
    for kw in (dict(pil_exact=False), dict(downsample="box"),
               dict(pil_exact=False, downsample="lanczos")):
        kw = dict(image_size=(32, 32), anti_aliasing=2, **kw)
        got = tcuda.render_rgb_batch(f, n, **kw)
        tables = tcuda.prepare(f, n, 64, 64, None, kw.get("pil_exact", True))
        plain = tcuda.render_rgb_batch_plain(tables, (32, 32), None,
                                             kw.get("downsample", "auto"))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        np.testing.assert_array_equal(
            got.numpy(), trasterize.render_rgb_batch(f, n, **kw).numpy())
        assert got.numpy().any()
    tables = tcuda.prepare(f, n, 32, 32, None)
    for wrapper in (tcuda.scene_raster, tcuda.packed_raster,
                    tcuda.strip_raster):
        launches = wrapper.launches
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(tables, (32, 32))
        assert wrapper.launches == launches
    # AA=1 takes the identity downsample whatever `downsample` says.
    out = tcuda.render_rgb_batch(f, n, image_size=(32, 32), downsample="box")
    assert out.shape == (1, 32, 32, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(
        out.numpy(), tcuda.render_rgb_batch(f, n, image_size=(32, 32)).numpy())


def test_renderer_cpu_paths_match_rasterizer():
    """ImageRenderer on CPU tensors: both fills go through the kernels'
    plain version, which equals ops/rasterize.py."""
    from spriteworld_torch.core import renderers

    rng = np.random.default_rng(50)
    f = torch.from_numpy(_sprites(rng, (2, 4), hsv=True))
    n = torch.tensor([4, 3], dtype=torch.int32)
    for pil_exact in (True, False):
        r = renderers.ImageRenderer((32, 32), anti_aliasing=2,
                                    color_to_rgb="hsv", pil_exact=pil_exact)
        want = trasterize.render_rgb_batch(f, n, image_size=(32, 32),
                                           anti_aliasing=2,
                                           color_to_rgb=tcolors.hsv_to_rgb,
                                           pil_exact=pil_exact)
        np.testing.assert_array_equal(r.render_batch(f, n, None).numpy(),
                                      want.numpy())
