"""Vertex generation for sprite shapes, vectorized.

The port's own copy of `spriteworld_tpu/ops/shapes.py` (the port imports
nothing of the JAX package). All generators return float64 numpy vertex
arrays normalized to unit area; they run once, when `spriteworld_torch.constants`
builds the vertex bank that the engine consumes.

Geometry conventions (identical to the reference):
  * vertices are listed counter-clockwise starting from angle `theta_0`,
  * every shape is scaled so its polygon area is exactly 1, which makes the
    sprite `scale` factor the edge length of an equivalent unit-area square.
"""

from __future__ import annotations

import numpy as np

__all__ = ["polygon", "star", "spokes"]


def _unit_circle_points(angles: np.ndarray, radius=1.0) -> np.ndarray:
    """Points at `radius` on the circle for an array of angles -> [N, 2]."""
    return radius * np.stack([np.cos(angles), np.sin(angles)], axis=-1)


def polygon(num_sides: int, theta_0: float = 0.0) -> np.ndarray:
    """Regular `num_sides`-gon with first vertex at angle `theta_0`.

    Area of a regular n-gon with circumradius 1 is n*sin(t/2)*cos(t/2) with
    t = 2*pi/n; dividing vertices by sqrt(area) normalizes area to 1
    (reference: shapes.py:34-49).
    """
    theta = 2.0 * np.pi / num_sides
    angles = theta_0 + theta * np.arange(num_sides)
    area = num_sides * np.sin(theta / 2.0) * np.cos(theta / 2.0)
    return _unit_circle_points(angles) / np.sqrt(area)


def star(num_sides: int, point_height: float = 1.0,
         theta_0: float = 0.0) -> np.ndarray:
    """Regular star: `num_sides` points of height `point_height`.

    Vertices alternate between the inscribed circle (radius 1, at angles
    i*t + theta_0) and the point tips (radius 1 + point_height, at angles
    (i+1/2)*t + theta_0). Area = (1+point_height)*n*sin(t/2)
    (reference: shapes.py:52-74).
    """
    theta = 2.0 * np.pi / num_sides
    idx = np.arange(num_sides)
    inner = _unit_circle_points(theta_0 + idx * theta)
    outer = _unit_circle_points(
        theta_0 + (idx + 0.5) * theta, radius=1.0 + point_height)
    verts = np.empty((2 * num_sides, 2), dtype=np.float64)
    verts[0::2] = inner
    verts[1::2] = outer
    area = (1.0 + point_height) * num_sides * np.sin(theta / 2.0)
    return verts / np.sqrt(area)


def spokes(num_sides: int, spoke_height: float = 1.0,
           theta_0: float = 0.0) -> np.ndarray:
    """Rectangular-spoke shape: like a star but with square-tipped points.

    For each base vertex v_i (radius 1, angle i*t + theta_0) we emit three
    vertices: v_i + s_{i-1/2}, v_i, v_i + s_{i+1/2}, where s_a is the spoke
    offset of length `spoke_height` at angle a*t + theta_0.
    Area = n*sin(t/2)*(2 + cos(t/2)) (reference: shapes.py:77-116).
    """
    theta = 2.0 * np.pi / num_sides
    idx = np.arange(num_sides)
    base = _unit_circle_points(theta_0 + idx * theta)
    spoke_lo = _unit_circle_points(
        theta_0 + (idx - 0.5) * theta, radius=spoke_height)
    spoke_hi = _unit_circle_points(
        theta_0 + (idx + 0.5) * theta, radius=spoke_height)
    verts = np.empty((3 * num_sides, 2), dtype=np.float64)
    verts[0::3] = base + spoke_lo
    verts[1::3] = base
    verts[2::3] = base + spoke_hi
    area = num_sides * np.sin(theta / 2.0) * (2.0 + np.cos(theta / 2.0))
    return verts / np.sqrt(area)
