"""Shared definitions across all COBRA tasks.

Counterpart of `spriteworld_tpu/configs/cobra/common.py`.
"""

from __future__ import annotations

from spriteworld_torch.core import actions
from spriteworld_torch.core import renderers as renderers_lib


def action_space():
    return actions.SelectMove(scale=0.25)


def renderers(anti_aliasing: int = 5):
    return {
        "image": renderers_lib.ImageRenderer(
            image_size=(64, 64),
            anti_aliasing=anti_aliasing,
            color_to_rgb="hsv",
        )
    }
