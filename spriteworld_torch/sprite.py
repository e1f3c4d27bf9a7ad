"""Host-side mutable Sprite: the reference-compatible object view.

The port's own copy of `spriteworld_tpu/sprite.py`. The engine keeps sprites
as batched factor tensors (core/state.py); this module gives the classic
object API of the reference Sprite (spriteworld/sprite.py:45-214) to the
dm_env adapter's SpritePassthrough observations, scripted host agents and
code written against the reference. It is pure numpy: the cached
transformed path becomes a cached vertex array with explicit affine updates.

Reference quirks reproduced on purpose (pinned by the reference's own
tests/sprite_test.py:138-174):

  * the ``angle`` setter rotates the cached vertices by the *delta* angle;
  * the ``scale`` setter multiplies the cached vertices by ``new - old`` —
    a delta, not a ratio — so 0.25 -> 0.5 yields a *smaller* shape;
  * the ``shape`` setter fully rebuilds the path from the registry.
"""

from __future__ import annotations

import collections

import numpy as np

from spriteworld_torch import constants

# Factor ordering of the reference (sprite.py:28-39).
FACTOR_NAMES = (
    "x", "y", "shape", "angle", "scale", "c0", "c1", "c2", "x_vel", "y_vel")

# Rejection-sampling guard of sample_contained_position (sprite.py:42).
_MAX_TRIES = int(1e6)


def _rotation(degrees: float) -> np.ndarray:
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s], [s, c]])


def _points_in_polygon(verts: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Even-odd crossing test; numpy mirror of ops.geometry's
    `points_in_polygons`."""
    points = np.atleast_2d(points)
    x1, y1 = verts[:, 0], verts[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    py = points[:, 1][:, None]
    straddles = (y1 > py) != (y2 > py)
    dy = np.where(y2 == y1, 1.0, y2 - y1)
    x_cross = x1 + (py - y1) * (x2 - x1) / dy
    crossings = (straddles & (points[:, 0][:, None] < x_cross)).sum(-1)
    return (crossings % 2) == 1


class Sprite:
    """Mutable sprite with the reference's factor API (sprite.py:45-214)."""

    def __init__(self, x=0.5, y=0.5, shape="square", angle=0, scale=0.1,
                 c0=0, c1=0, c2=0, x_vel=0.0, y_vel=0.0):
        self._position = np.array([x, y], dtype=np.float64)
        self._shape = shape
        self._angle = angle
        self._scale = scale
        self._color = (c0, c1, c2)
        self._velocity = (x_vel, y_vel)
        self._reset_centered_vertices()

    def _reset_centered_vertices(self):
        # Scale first, then rotate (reference _reset_centered_path order,
        # sprite.py:96-101).
        base = np.asarray(constants.SHAPES[self._shape], dtype=np.float64)
        self._centered = (base * self._scale) @ _rotation(self._angle).T

    # ------------------------------------------------------------------ #
    # Dynamics (sprite.py:103-111)
    # ------------------------------------------------------------------ #
    def move(self, motion, keep_in_frame=False):
        self._position = self._position + np.asarray(motion)
        if keep_in_frame:
            self._position = np.clip(self._position, 0.0, 1.0)

    def update_position(self, keep_in_frame=False):
        self.move(self._velocity, keep_in_frame=keep_in_frame)

    # ------------------------------------------------------------------ #
    # Geometry (sprite.py:113-138)
    # ------------------------------------------------------------------ #
    def contains_point(self, point):
        return bool(_points_in_polygon(
            self._centered, np.asarray(point) - self._position)[0])

    def sample_contained_position(self):
        low = self._centered.min(axis=0)
        high = self._centered.max(axis=0)
        for _ in range(_MAX_TRIES):
            sample = self._position + np.random.uniform(low, high)
            if self.contains_point(sample):
                return sample
        raise ValueError("max_tries exceeded in sample_contained_position.")

    @property
    def vertices(self):
        return self._centered + self._position

    @property
    def out_of_frame(self):
        return not (np.all(self._position >= [0.0, 0.0])
                    and np.all(self._position <= [1.0, 1.0]))

    # ------------------------------------------------------------------ #
    # Factor properties / setters (sprite.py:140-214)
    # ------------------------------------------------------------------ #
    @property
    def x(self):
        return self._position[0]

    @property
    def y(self):
        return self._position[1]

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, s):
        self._shape = s
        self._reset_centered_vertices()

    @property
    def angle(self):
        return self._angle

    @angle.setter
    def angle(self, a):
        # Rotate the cached vertices by the delta (sprite.py:161-165).
        self._centered = self._centered @ _rotation(a - self._angle).T
        self._angle = a

    @property
    def scale(self):
        return self._scale

    @scale.setter
    def scale(self, s):
        # Deliberate reference quirk: scale by the DELTA, not the ratio
        # (sprite.py:171-175; pinned by its tests/sprite_test.py:163-174).
        self._centered = self._centered * (s - self._scale)
        self._scale = s

    @property
    def c0(self):
        return self._color[0]

    @property
    def c1(self):
        return self._color[1]

    @property
    def c2(self):
        return self._color[2]

    @property
    def x_vel(self):
        return self._velocity[0]

    @property
    def y_vel(self):
        return self._velocity[1]

    @property
    def color(self):
        return self._color

    @property
    def position(self):
        return self._position

    @property
    def velocity(self):
        return self._velocity

    @property
    def factors(self):
        out = collections.OrderedDict()
        for name in FACTOR_NAMES:
            out[name] = getattr(self, name)
        return out


def from_factor_row(row, factor_names=FACTOR_NAMES) -> Sprite:
    """Build a Sprite from one row of the engine's factor matrix
    (shape ids resolve back to names)."""
    kwargs = {}
    for i, name in enumerate(factor_names):
        v = float(row[i])
        if name == "shape":
            v = constants.ShapeType(int(v)).name
        kwargs[name] = v
    return Sprite(**kwargs)
