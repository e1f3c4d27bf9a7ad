"""Port parity, host Sprite: spriteworld_torch.sprite against the JAX
package's sprite.py (both numpy), and constants.shape_id.

Both compute vertices with the same numpy float64 arithmetic, so every
comparison here is exact.
"""

import numpy as np
import pytest

from spriteworld_tpu import constants as jconstants
from spriteworld_tpu import sprite as jsprite

from spriteworld_torch import constants as tconstants
from spriteworld_torch import sprite as tsprite

_SHAPES = sorted(tconstants.SHAPES)


def _kwargs(rng, shape):
    return dict(x=rng.uniform(0.1, 0.9), y=rng.uniform(0.1, 0.9),
                shape=shape, angle=rng.uniform(0, 360),
                scale=rng.uniform(0.05, 0.3), c0=rng.uniform(0, 1),
                c1=rng.uniform(0, 1), c2=rng.uniform(0, 1),
                x_vel=rng.uniform(-0.05, 0.05), y_vel=rng.uniform(-0.05, 0.05))


def _both(kw):
    return jsprite.Sprite(**kw), tsprite.Sprite(**kw)


def _points(rng, sprite, n=256):
    """Points around a sprite: half in its bounding box, half anywhere."""
    v = sprite.vertices
    box = rng.uniform(v.min(0), v.max(0), (n // 2, 2))
    return np.concatenate([box, rng.uniform(-0.1, 1.1, (n - n // 2, 2))])


@pytest.mark.parametrize("shape", _SHAPES)
def test_vertices_and_containment_equal_jax(shape):
    rng = np.random.default_rng(tconstants.shape_id(shape))
    j, t = _both(_kwargs(rng, shape))
    np.testing.assert_array_equal(t.vertices, j.vertices)  # exact
    pts = _points(rng, t)
    got = [t.contains_point(p) for p in pts]
    assert got == [j.contains_point(p) for p in pts]  # exact
    assert 0 < sum(got) < len(got)


def test_setter_quirks_equal_jax():
    """The angle setter rotates by the delta, the scale setter multiplies
    by the delta (0.25 -> 0.5 gives a smaller shape), the shape setter
    rebuilds the path: vertices equal the JAX copy's after each (exact)."""
    rng = np.random.default_rng(0)
    j, t = _both(_kwargs(rng, "star_5"))
    for attr, value in [("angle", 30.0), ("angle", 200.0), ("scale", 0.5),
                        ("scale", 0.2), ("shape", "spoke_6"),
                        ("angle", 45.0)]:
        setattr(j, attr, value)
        setattr(t, attr, value)
        assert getattr(t, attr) == value
        np.testing.assert_array_equal(t.vertices, j.vertices)
    # The reference's own pin (sprite_test.py): scale 0.25 -> 0.5 shrinks.
    s = tsprite.Sprite(shape="square", scale=0.25)
    width = np.ptp(s.vertices[:, 0])
    s.scale = 0.5
    assert np.ptp(s.vertices[:, 0]) < width


@pytest.mark.parametrize("keep_in_frame", [False, True])
def test_move_update_position_and_out_of_frame_equal_jax(keep_in_frame):
    rng = np.random.default_rng(1 + keep_in_frame)
    j, t = _both(_kwargs(rng, "triangle"))
    for motion in ([0.3, -0.2], [0.5, 0.9], [-2.0, 0.1]):
        j.move(motion, keep_in_frame)
        t.move(motion, keep_in_frame)
        np.testing.assert_array_equal(t.position, j.position)  # exact
        assert t.out_of_frame == j.out_of_frame
        j.update_position(keep_in_frame)
        t.update_position(keep_in_frame)
        np.testing.assert_array_equal(t.position, j.position)
        np.testing.assert_array_equal(t.vertices, j.vertices)
    assert t.out_of_frame != keep_in_frame


def test_factors_and_from_factor_row_equal_jax():
    rng = np.random.default_rng(2)
    for shape in _SHAPES:
        row = np.array([rng.uniform(0, 1), rng.uniform(0, 1),
                        tconstants.shape_id(shape), rng.uniform(0, 360),
                        rng.uniform(0.05, 0.3), *rng.uniform(0, 1, 3),
                        *rng.uniform(-0.05, 0.05, 2)], np.float32)
        j = jsprite.from_factor_row(row)
        t = tsprite.from_factor_row(row)
        assert t.shape == shape
        assert list(t.factors.items()) == list(j.factors.items())  # exact
        np.testing.assert_array_equal(t.vertices, j.vertices)
    assert tsprite.FACTOR_NAMES == jsprite.FACTOR_NAMES


@pytest.mark.parametrize("shape", ["triangle", "star_4", "spoke_5"])
def test_sample_contained_position_inside_and_equal_jax(shape):
    """Both draw from numpy's global generator: from one seed, the same
    points (exact), each inside the polygon."""
    rng = np.random.default_rng(3)
    j, t = _both(_kwargs(rng, shape))
    np.random.seed(11)
    got = [t.sample_contained_position() for _ in range(20)]
    np.random.seed(11)
    want = [j.sample_contained_position() for _ in range(20)]
    np.testing.assert_array_equal(got, want)
    assert all(t.contains_point(p) for p in got)


def test_shape_id_and_tables_equal_jax():
    for s in tconstants.ShapeType:
        assert tconstants.shape_id(s.name) == jconstants.shape_id(s.name)
        assert tconstants.shape_id(s.value) == s.value
        assert tconstants.shape_id(float(s.value)) == s.value
    with pytest.raises(KeyError):
        tconstants.shape_id("hexagram")
    np.testing.assert_array_equal(tconstants.VERTEX_BANK,
                                  jconstants.VERTEX_BANK)
