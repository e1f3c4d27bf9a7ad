"""Color-space conversions on tensors.

Counterpart of `spriteworld_tpu/utils/colors.py`, with the same operation
order so that float32 results agree with it.
"""

from __future__ import annotations

import torch


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Vectorized HSV -> RGB in [0, 255], matching colorsys + uint8 cast.

    The reference computes `(255 * colorsys.hsv_to_rgb(*c)).astype(uint8)`
    (truncation); callers truncate the returned floats to uint8.
    """
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int64) % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    idx = i[..., None]
    # Channel tables indexed by sector i (colorsys's 6-way branch).
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, idx)[..., 0]
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, idx)[..., 0]
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, idx)[..., 0]
    return 255.0 * torch.stack([r, g, b], dim=-1)



def identity_255(colors: torch.Tensor) -> torch.Tensor:
    """Pass-through for colors already expressed in [0, 255]."""
    return colors
