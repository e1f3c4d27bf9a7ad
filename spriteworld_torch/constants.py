"""Canonical shape registry and the static vertex bank.

The port's own copy of `spriteworld_tpu/constants.py`: the same shape table,
`ShapeType` ids and padded vertex bank `VERTEX_BANK[num_shapes+1,
MAX_VERTICES, 2]`, so the engine gathers a sprite's polygon with one indexed
load. Row 0 is the null shape (all zeros); rows 1..12 follow `ShapeType`.

Padding rule: slots past a shape's vertex count repeat vertex 0. Since the
point-in-polygon test closes the polygon with a wrap edge, the padded edges
are (v_last -> v_0) — the true closing edge — followed by zero-length
(v_0 -> v_0) edges, which can never produce a crossing. Containment over the
padded bank is therefore exact without any per-shape masking.
"""

from __future__ import annotations

import enum

import numpy as np

from spriteworld_torch.ops import shapes

# Canonical shapes with the reference's fixed orientations
# (reference: constants.py:27-40).
SHAPES = {
    "triangle": shapes.polygon(num_sides=3, theta_0=np.pi / 2),
    "square": shapes.polygon(num_sides=4, theta_0=np.pi / 4),
    "pentagon": shapes.polygon(num_sides=5, theta_0=np.pi / 2),
    "hexagon": shapes.polygon(num_sides=6),
    "octagon": shapes.polygon(num_sides=8),
    "circle": shapes.polygon(num_sides=30),
    "star_4": shapes.star(num_sides=4, theta_0=np.pi / 4),
    "star_5": shapes.star(num_sides=5, theta_0=np.pi + np.pi / 10),
    "star_6": shapes.star(num_sides=6),
    "spoke_4": shapes.spokes(num_sides=4, theta_0=np.pi / 4),
    "spoke_5": shapes.spokes(num_sides=5, theta_0=np.pi + np.pi / 10),
    "spoke_6": shapes.spokes(num_sides=6),
}


class ShapeType(enum.IntEnum):
    """Integer ids for shapes (the observation contract of SpriteFactors)."""

    triangle = 1
    square = 2
    pentagon = 3
    hexagon = 4
    octagon = 5
    circle = 6
    star_4 = 7
    star_5 = 8
    star_6 = 9
    spoke_4 = 10
    spoke_5 = 11
    spoke_6 = 12


SHAPE_NAMES = tuple(s.name for s in ShapeType)
NUM_SHAPES = len(ShapeType)
MAX_VERTICES = max(v.shape[0] for v in SHAPES.values())  # 30 (circle)


def _build_vertex_bank():
    bank = np.zeros((NUM_SHAPES + 1, MAX_VERTICES, 2), dtype=np.float32)
    counts = np.zeros((NUM_SHAPES + 1,), dtype=np.int32)
    for shape_type in ShapeType:
        verts = SHAPES[shape_type.name]
        n = verts.shape[0]
        bank[shape_type.value, :n] = verts
        bank[shape_type.value, n:] = verts[0]  # pad = repeat first vertex
        counts[shape_type.value] = n
    return bank, counts


# Host tables. VERTEX_BANK: f32[13, 30, 2]; VERTEX_COUNTS: i32[13].
VERTEX_BANK, VERTEX_COUNTS = _build_vertex_bank()


def shape_id(shape) -> int:
    """Resolve a shape name or id to its integer ShapeType value."""
    if isinstance(shape, str):
        return ShapeType[shape].value
    return int(shape)
