"""Renderers: batched observation functions over the factor state.

Counterpart of `spriteworld_tpu/core/renderers.py`. Each renderer offers
``render(factors f32[B, K, 10], num_sprites i32[B], success bool[B])``:

  * SpriteFactors — selected factor columns [B, K, F] + live mask [B, K].
  * SpritePassthrough — the whole factor tensor [B, K, 10] + live counts
    [B] (the engine's analogue of the reference's Sprite list).
  * Success — the task success flag [B].
  * ImageRenderer — RGB pixels u8[B, H, W, 3], in every fill and
    downsample mode. A CUDA batch goes to a kernel of
    `ops/rasterize_cuda.py`: the anti_aliasing=1 small-canvas kernel where
    the JAX package takes its packed mode, else the scene kernel when its
    canvas fits one block's shared memory and the row-strip kernels
    otherwise (`kernel_mode`); a CPU batch goes to their plain version.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import rasterize_cuda
from spriteworld_torch.utils import colors as color_maps


class AbstractRenderer:
    """Interface: render(factors, num_sprites, success) + observation_spec."""

    max_sprites: Optional[int] = None  # set by the environment at bind time

    def bind(self, max_sprites: int):
        """Called by the environment so specs can be static."""
        self.max_sprites = max_sprites
        return self

    def render(self, factors, num_sprites, success):
        raise NotImplementedError

    def observation_spec(self):
        """(per-lane shape, dtype) of the observation."""
        raise NotImplementedError


class SpriteFactors(AbstractRenderer):
    """Selected factor columns as a dense tensor + live mask."""

    def __init__(self, factors: Sequence[str] = state_lib.FACTOR_NAMES):
        if not set(factors).issubset(set(state_lib.FACTOR_NAMES)):
            raise ValueError(
                f"Factors have to belong to {state_lib.FACTOR_NAMES}.")
        self._factors = tuple(factors)
        self._columns = [state_lib.FACTOR_INDEX[f] for f in factors]

    @property
    def factor_names(self):
        return self._factors

    def render(self, factors, num_sprites, success):
        del success
        k = factors.shape[-2]
        return {
            "factors": factors[..., self._columns],
            "mask": (torch.arange(k, device=factors.device)
                     < num_sprites[:, None]),
        }

    def observation_spec(self):
        k = self.max_sprites
        return {"factors": ((k, len(self._factors)), torch.float32),
                "mask": ((k,), torch.bool)}


class SpritePassthrough(AbstractRenderer):
    """The full packed factor state (engine analogue of the Sprite list)."""

    def render(self, factors, num_sprites, success):
        del success
        return {"factors": factors, "num_sprites": num_sprites}

    def observation_spec(self):
        return {"factors": ((self.max_sprites, state_lib.NUM_FACTORS),
                            torch.float32),
                "num_sprites": ((), torch.int32)}


class Success(AbstractRenderer):
    """Task success flag as a boolean observation."""

    def render(self, factors, num_sprites, success):
        del factors, num_sprites
        return success

    def observation_spec(self):
        return ((), torch.bool)


def _resolve_color_map(color_to_rgb) -> Optional[Callable]:
    if color_to_rgb is None:
        return None
    if callable(color_to_rgb):
        return color_to_rgb
    if color_to_rgb == "hsv":
        return color_maps.hsv_to_rgb
    raise ValueError(f"Unknown color_to_rgb: {color_to_rgb!r}")


class ImageRenderer(AbstractRenderer):
    """Anti-aliased RGB rendering of the scene.

    Functional analogue of the reference PILRenderer: supersampled canvas,
    back-to-front polygon painting, vertical flip to math coordinates. By
    default (pil_exact=True, downsample="auto") observations equal the
    reference's at every anti_aliasing: Pillow's scanline fill and Pillow's
    Lanczos filter. pil_exact=False selects centroid sampling + box average;
    downsample="box"/"lanczos" forces a filter. kernel_mode picks the card's
    kernel: "scene" (one block a scene), "strips" (one block a strip of
    canvas rows) or "auto" (the scene kernel where its layout fits the
    card's shared memory per block; `rasterize_cuda.resolve_kernel_mode`).
    "auto" and "strips" take the anti_aliasing=1 small-canvas kernel where
    `rasterize_cuda.uses_packed` holds.
    """

    def __init__(self,
                 image_size: Tuple[int, int] = (64, 64),
                 anti_aliasing: int = 1,
                 bg_color: Optional[Tuple[int, int, int]] = None,
                 color_to_rgb: Union[None, str, Callable] = None,
                 pil_exact: Union[bool, str] = "auto",
                 downsample: str = "auto",
                 kernel_mode: str = "auto"):
        self._image_size = tuple(image_size)
        self._anti_aliasing = int(anti_aliasing)
        if self._anti_aliasing < 1 or min(self._image_size) < 1:
            raise ValueError(
                f"image_size {image_size} and anti_aliasing {anti_aliasing} "
                "must be positive.")
        self._bg_color = bg_color
        self._color_to_rgb = _resolve_color_map(color_to_rgb)
        if pil_exact == "auto":
            pil_exact = True
        self._pil_exact = bool(pil_exact)
        if downsample not in rasterize_cuda.DOWNSAMPLES:
            raise ValueError(f"Unknown downsample: {downsample!r}")
        self._downsample = downsample
        if kernel_mode not in rasterize_cuda.KERNEL_MODES:
            raise ValueError(f"Unknown kernel_mode: {kernel_mode!r}")
        self._kernel_mode = kernel_mode

    @property
    def image_size(self):
        return self._image_size

    def render(self, factors, num_sprites, success):
        del success
        return rasterize_cuda.render_rgb_batch(
            factors, num_sprites, image_size=self._image_size,
            anti_aliasing=self._anti_aliasing, bg_color=self._bg_color,
            color_to_rgb=self._color_to_rgb, pil_exact=self._pil_exact,
            downsample=self._downsample, kernel_mode=self._kernel_mode)

    def observation_spec(self):
        return (self._image_size + (3,), torch.uint8)


# Familiar alias: reference users construct `PILRenderer`.
PILRenderer = ImageRenderer
