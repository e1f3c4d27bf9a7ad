"""Port parity, low-level ops: constants, colors, geometry, Lanczos.

The same inputs, made with numpy from a seed, go through the JAX package
and the PyTorch port (spriteworld_torch) on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from spriteworld_tpu import constants as jconstants
from spriteworld_tpu.ops import geometry as jgeometry
from spriteworld_tpu.ops import resample as jresample
from spriteworld_tpu.utils import colors as jcolors

from spriteworld_torch import constants as tconstants
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import geometry as tgeometry
from spriteworld_torch.ops import resample as tresample
from spriteworld_torch.utils import colors as tcolors
from spriteworld_torch.utils import device as tdevice

_jit_hsv = jax.jit(jcolors.hsv_to_rgb)
_jit_world = jax.jit(jgeometry.world_vertices)
_jit_contains = jax.jit(
    lambda v, p: jgeometry.points_in_polygons(v[:, None], p[None]))


def _factors(rng, k, angle=None):
    f = np.tile(tstate.DEFAULT_FACTORS, (k, 1)).astype(np.float32)
    f[:, tstate.X] = rng.uniform(0.1, 0.9, k)
    f[:, tstate.Y] = rng.uniform(0.1, 0.9, k)
    f[:, tstate.SHAPE] = rng.integers(1, 13, k)
    f[:, tstate.ANGLE] = rng.uniform(0, 360, k) if angle is None else angle
    f[:, tstate.SCALE] = rng.uniform(0.05, 0.3, k)
    return f


def test_vertex_bank_and_counts_equal_jax():
    assert tconstants.VERTEX_BANK.dtype == jconstants.VERTEX_BANK.dtype
    np.testing.assert_array_equal(tconstants.VERTEX_BANK,
                                  jconstants.VERTEX_BANK)
    np.testing.assert_array_equal(tconstants.VERTEX_COUNTS,
                                  jconstants.VERTEX_COUNTS)


def test_shape_types_and_state_layout_equal_jax():
    from spriteworld_tpu.core import state as jstate

    assert [(s.name, s.value) for s in tconstants.ShapeType] \
        == [(s.name, s.value) for s in jconstants.ShapeType]
    assert tconstants.MAX_VERTICES == jconstants.MAX_VERTICES
    assert tstate.FACTOR_NAMES == jstate.FACTOR_NAMES
    np.testing.assert_array_equal(tstate.DEFAULT_FACTORS,
                                  jstate.DEFAULT_FACTORS)
    assert (tstate.StepType.FIRST, tstate.StepType.MID,
            tstate.StepType.LAST) == (0, 1, 2)


@pytest.mark.parametrize("in_size,out_size",
                         [(320, 64), (64, 32), (128, 64), (77, 11), (65, 13)])
def test_lanczos_taps_equal_jax(in_size, out_size):
    got = tresample.pil_lanczos_matrix(in_size, out_size)
    want = jresample.pil_lanczos_matrix(in_size, out_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # Each tap is an integer over 2^22.
    q = tresample.pil_lanczos_matrix_q(in_size, out_size)
    np.testing.assert_array_equal(got.astype(np.float64) * 2.0 ** 22, q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_to_rgb_u8_matches_jax(seed):
    """XLA on the CPU contracts h*6 - i and the like into FMAs, so ~5% of
    the float outputs differ by an ulp; after the uint8 truncation the
    values are equal, with +-1 allowed on at most 1e-5 of them."""
    rng = np.random.default_rng(seed)
    hsv = rng.uniform(0, 1, (100_000, 3)).astype(np.float32)
    want = np.clip(np.asarray(_jit_hsv(hsv)), 0, 255).astype(np.uint8)
    got = tcolors.hsv_to_rgb(torch.from_numpy(hsv)).clamp(0, 255).to(
        torch.uint8).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_world_vertices_match_jax(seed):
    """Trig differs by an ulp between the two on some angles: atol 2e-5,
    the tolerance of tests/test_geometry.py."""
    f = _factors(np.random.default_rng(seed), 256)
    want = np.asarray(_jit_world(f))
    got = tgeometry.world_vertices(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_world_vertices_exact_at_angle_zero():
    f = _factors(np.random.default_rng(3), 256, angle=0.0)
    np.testing.assert_array_equal(
        tgeometry.world_vertices(torch.from_numpy(f)).numpy(),
        np.asarray(_jit_world(f)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_containment_dense_grid_exact(seed):
    """Identical vertices into both: containment equal on a dense grid
    through all 12 shapes (concave stars and spokes included)."""
    rng = np.random.default_rng(seed)
    f = _factors(rng, 12)
    f[:, tstate.SHAPE] = np.arange(1, 13)
    f[:, tstate.SCALE] = rng.uniform(0.2, 0.4, 12)
    verts = np.array(_jit_world(f))
    g = np.linspace(0, 1, 201, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2)
    want = np.asarray(_jit_contains(verts, pts))
    got = tgeometry.points_in_polygons(
        torch.from_numpy(verts)[:, None], torch.from_numpy(pts)[None]).numpy()
    assert want.sum() > 1000
    np.testing.assert_array_equal(got, want)


def test_sprites_containing_point_and_topmost_hit():
    f = _factors(np.random.default_rng(4), 6)
    f[:, tstate.X] = 0.5
    f[:, tstate.Y] = 0.5
    f[:, tstate.SCALE] = 0.3
    factors = torch.from_numpy(f)[None].repeat(3, 1, 1)
    points = torch.tensor([[0.5, 0.5], [0.99, 0.01], [0.5, 0.5]])
    hits = tgeometry.sprites_containing_point(factors, points)
    assert hits[0].all() and not hits[1].any()
    idx, any_hit = tgeometry.topmost_hit(
        hits, torch.tensor([6, 6, 3], dtype=torch.int32))
    assert idx.tolist() == [5, 0, 2]
    assert any_hit.tolist() == [True, False, True]


def test_out_of_frame_counts_live_sprites_only():
    f = np.tile(tstate.DEFAULT_FACTORS, (2, 3, 1)).astype(np.float32)
    f[0, 2, tstate.X] = 1.2  # dead slot in lane 0 (2 live sprites)
    f[1, 1, tstate.Y] = -0.1  # live slot in lane 1
    got = tgeometry.out_of_frame(torch.from_numpy(f),
                                 torch.tensor([2, 2], dtype=torch.int32))
    assert got.tolist() == [False, True]


_RESIZE_SHAPES = [(96, 96, 32, 32), (65, 77, 13, 11), (320, 320, 64, 64)]


@pytest.mark.parametrize("hc,wc,h,w", _RESIZE_SHAPES)
def test_pil_resize_lanczos_bitexact_vs_pillow(hc, wc, h, w):
    rng = np.random.default_rng(hc + wc)
    img = rng.integers(0, 256, (hc, wc, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(
        (w, h), resample=Image.LANCZOS))
    got = tresample.pil_resize_lanczos(torch.from_numpy(img), h, w).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hc,wc,h,w", _RESIZE_SHAPES)
def test_pil_resize_lanczos_within_one_of_jax(hc, wc, h, w):
    """The JAX resize sums in float32, which can round a value the other
    way: +-1 against it, exact against Pillow (above)."""
    rng = np.random.default_rng(hc * wc)
    img = rng.integers(0, 256, (2, hc, wc, 3), dtype=np.uint8)
    got = tresample.pil_resize_lanczos(torch.from_numpy(img), h, w).numpy()
    for i in range(2):
        want = np.asarray(jresample.pil_resize_lanczos(
            jnp.asarray(img[i], jnp.float32), h, w)).astype(np.uint8)
        assert np.abs(got[i].astype(int) - want.astype(int)).max() <= 1


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.state_from_numpy({})
    assert tdevice.resolve("cpu") == torch.device("cpu")
