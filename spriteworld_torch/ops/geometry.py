"""Batched sprite geometry: vertex transforms and point-in-polygon tests.

Counterpart of `spriteworld_tpu/ops/geometry.py`. Vertices are recomputed
from factors on demand: a gather from the vertex bank, a scale, an
elementwise rotation and a translation. The containment test is the
even-odd crossing-number rule, which agrees with matplotlib's
`Path.contains_point` on the simple polygons of the shape bank.
"""

from __future__ import annotations

import numpy as np
import torch

from spriteworld_torch import constants
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.utils import device as device_lib

_DEG2RAD = np.pi / 180.0


def vertex_bank(device) -> torch.Tensor:
    """The padded vertex bank f32[13, 30, 2] on `device`."""
    return device_lib.constant(constants.VERTEX_BANK, device)


def centered_vertices(factors: torch.Tensor) -> torch.Tensor:
    """Scaled+rotated (but untranslated) vertices for sprites [..., 10].

    Scale, then rotate counter-clockwise (mpl Affine2D().rotate_deg).
    Returns f32[..., MAX_VERTICES, 2]. The rotation is written out
    elementwise — never a matmul — so no TF32 setting can touch it.

    The angle in radians is the float32 product the JAX package computes;
    its sine and cosine are taken in float64 and rounded once to float32.
    float32 sine and cosine round differently on the card and on the CPU
    (some 4% of vertex values differ, and with them picks near an edge);
    both round a float64 value within an ulp of the true one to the same
    float32 but for ties one in ~10^8 apart.
    """
    shape_id = factors[..., state_lib.SHAPE].to(torch.int64)
    base = vertex_bank(factors.device)[shape_id]  # [..., V, 2]
    scaled = base * factors[..., state_lib.SCALE][..., None, None]
    rad = (factors[..., state_lib.ANGLE] * _DEG2RAD).to(torch.float64)
    c = torch.cos(rad).to(torch.float32)[..., None]
    s = torch.sin(rad).to(torch.float32)[..., None]
    vx = scaled[..., 0]
    vy = scaled[..., 1]
    return torch.stack([c * vx - s * vy, s * vx + c * vy], dim=-1)


def world_vertices(factors: torch.Tensor) -> torch.Tensor:
    """World-space vertices: centered vertices + position."""
    pos = factors[..., None, 0:2]  # columns (X, Y)
    return centered_vertices(factors) + pos


def points_in_polygons(vertices: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """Even-odd containment of points in closed polygons.

    Args:
      vertices: f32[..., V, 2] polygon vertices (padding slots must repeat an
        existing vertex so padded edges are degenerate — see constants.py).
      points: f32[..., 2] query points, broadcast against the polygon batch.

    Returns:
      bool[...] — True where the point lies inside the polygon.
    """
    px = points[..., 0]
    py = points[..., 1]
    x1 = vertices[..., 0]
    y1 = vertices[..., 1]
    x2 = torch.roll(x1, -1, dims=-1)  # wrap edge V-1 -> 0 closes the polygon
    y2 = torch.roll(y1, -1, dims=-1)
    py_ = py[..., None]
    straddles = (y1 > py_) != (y2 > py_)
    dy = y2 - y1
    # Guard the horizontal-edge division; such edges never straddle.
    t = (py_ - y1) / torch.where(dy == 0.0, torch.ones_like(dy), dy)
    x_cross = x1 + t * (x2 - x1)
    crossings = (straddles & (px[..., None] < x_cross)).sum(-1)
    return (crossings & 1) == 1


def sprites_containing_point(factors: torch.Tensor,
                             point: torch.Tensor) -> torch.Tensor:
    """bool[B, K] — which sprites of each lane contain that lane's point.

    factors: f32[B, K, 10]; point: f32[B, 2].
    """
    return points_in_polygons(world_vertices(factors), point[..., None, :])


def topmost_hit(hit_mask: torch.Tensor, limit: torch.Tensor):
    """Select the foreground-most live sprite from a hit mask.

    The reference scans `sprites[::-1]` and takes the first hit: with slot
    order = z-order that is the *highest* hit slot index below `limit`.
    hit_mask: bool[B, K]; limit: i32[B].

    Returns (index i64[B], any_hit bool[B]). Index is 0 when there is no hit.
    """
    k = hit_mask.shape[-1]
    idx = torch.arange(k, device=hit_mask.device)
    valid = hit_mask & (idx < limit[..., None])
    any_hit = valid.any(-1)
    top = torch.where(valid, idx, torch.full_like(idx, -1)).amax(-1)
    return top.clamp(min=0), any_hit


def out_of_frame(factors: torch.Tensor,
                 num_sprites: torch.Tensor) -> torch.Tensor:
    """bool[B]: any live sprite's center left [0, 1]^2."""
    pos = factors[..., 0:2]  # columns (X, Y)
    k = factors.shape[-2]
    alive = torch.arange(k, device=factors.device) < num_sprites[..., None]
    escaped = ((pos < 0.0) | (pos > 1.0)).any(-1)
    return (escaped & alive).any(-1)
