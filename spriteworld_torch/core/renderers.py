"""Renderers: observation functions over the factor state.

Counterpart of `spriteworld_tpu/core/renderers.py`, with its contract: each
renderer offers ``render(factors f32[K, 10], num_sprites i32[], success
bool[])`` of one scene and ``render_batch(factors f32[B, K, 10],
num_sprites i32[B], success bool[B])`` of a batch, and
``observation_spec()`` of one scene's observation as `ShapeDtype`s:

  * SpriteFactors — selected factor columns [K, F] + live mask [K].
  * SpritePassthrough — the whole factor tensor [K, 10] + the live count
    (the engine's analogue of the reference's Sprite list).
  * Success — the task success flag.
  * ImageRenderer — RGB pixels u8[H, W, 3], in every fill and downsample
    mode. A CUDA batch goes to a kernel of `ops/rasterize_cuda.py`: the
    anti_aliasing=1 small-canvas kernel where the JAX package takes its
    packed mode, else the scene kernel when its canvas fits one block's
    shared memory and the row-strip kernels otherwise (`kernel_mode`); a
    CPU batch goes to their plain version. One scene is the batch of one.

A renderer that only defines `render` gets `render_batch` as
`torch.func.vmap(self.render)`, as the JAX package's default is
`jax.vmap(self.render)`. The built-ins batch with their own bodies, which
the steps and their CUDA graphs run; a subclass of SpriteFactors,
SpritePassthrough or Success that overrides `render` gets the vmap of its
own `render`, as it does in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import rasterize_cuda
from spriteworld_torch.utils import colors as color_maps
from spriteworld_torch.utils import device as device_lib


class ShapeDtype(NamedTuple):
    """Shape and dtype of one scene's observation: the counterpart of
    `jax.ShapeDtypeStruct`, which unpacks as a (shape, dtype) pair."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class AbstractRenderer:
    """Interface: render(factors, num_sprites, success) of one scene,
    render_batch of a batch, and observation_spec."""

    max_sprites: Optional[int] = None  # set by the environment at bind time

    def bind(self, max_sprites: int):
        """Called by the environment so specs can be static."""
        self.max_sprites = max_sprites
        return self

    def render(self, factors, num_sprites, success):
        """One scene: factors f32[K, 10], num_sprites i32[], success bool[]
        -> a tensor or a dict of tensors."""
        raise NotImplementedError

    def render_batch(self, factors, num_sprites, success):
        """A batch: factors f32[B, K, 10], num_sprites i32[B], success
        bool[B] or None -> `render`'s outputs with a leading B axis.

        The default is `torch.func.vmap(self.render)`. Inside it `render`
        sees one scene and must not read a tensor's value on the host
        (`.item()`, `bool()`, a Python `if` on a tensor): vmap refuses that,
        as `jax.vmap` refuses it under tracing, and so would the capture of
        a CUDA graph that holds the step. Override it with a batched body
        where one is at hand.
        """
        in_dims = (0, 0, None if success is None else 0)
        return torch.func.vmap(self.render, in_dims=in_dims)(
            factors, num_sprites, success)

    def observation_spec(self):
        """`ShapeDtype` of one scene's observation (a dict of them for a
        dict-valued observation)."""
        raise NotImplementedError


class _AnyLeadingAxes(AbstractRenderer):
    """A built-in whose `render` body holds for any leading axes:
    `render_batch` runs that body on the batch, unless a subclass overrides
    `render`, which then gets the default, the vmap of its own `render`."""

    def render_batch(self, factors, num_sprites, success):
        if type(self).render in _ANY_LEADING_AXES:
            return self.render(factors, num_sprites, success)
        return super().render_batch(factors, num_sprites, success)


class SpriteFactors(_AnyLeadingAxes):
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
        """One scene or, as `render_batch`, a batch: the body holds for any
        leading axes."""
        del success
        k = factors.shape[-2]
        # The columns as a cached device index: indexing with the Python
        # list would copy it to the device each call, which a CUDA graph
        # capture refuses.
        columns = device_lib.constant(np.asarray(self._columns, np.int64),
                                      factors.device)
        return {
            "factors": factors.index_select(-1, columns),
            "mask": (torch.arange(k, device=factors.device)
                     < num_sprites[..., None]),
        }

    def observation_spec(self):
        k = self.max_sprites
        return {"factors": ShapeDtype((k, len(self._factors)), torch.float32),
                "mask": ShapeDtype((k,), torch.bool)}


class SpritePassthrough(_AnyLeadingAxes):
    """The full packed factor state (engine analogue of the Sprite list)."""

    def render(self, factors, num_sprites, success):
        del success
        return {"factors": factors, "num_sprites": num_sprites}

    def observation_spec(self):
        return {"factors": ShapeDtype(
                    (self.max_sprites, state_lib.NUM_FACTORS), torch.float32),
                "num_sprites": ShapeDtype((), torch.int32)}


class Success(_AnyLeadingAxes):
    """Task success flag as a boolean observation."""

    def render(self, factors, num_sprites, success):
        del factors, num_sprites
        return success

    def observation_spec(self):
        return ShapeDtype((), torch.bool)


# The `render`s that `_AnyLeadingAxes.render_batch` runs on a batch.
_ANY_LEADING_AXES = frozenset(
    (SpriteFactors.render, SpritePassthrough.render, Success.render))


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

    The JAX package's `use_pallas` has no counterpart: factors on the card
    always render through its kernels, and a failing kernel raises.
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

    def _kwargs(self):
        return dict(image_size=self._image_size,
                    anti_aliasing=self._anti_aliasing,
                    bg_color=self._bg_color, color_to_rgb=self._color_to_rgb,
                    pil_exact=self._pil_exact, downsample=self._downsample,
                    kernel_mode=self._kernel_mode)

    def render(self, factors, num_sprites, success):
        """One scene -> u8[H, W, 3]: the batch of one, through the kernel a
        batch takes."""
        del success
        return rasterize_cuda.render_rgb(factors, num_sprites,
                                         **self._kwargs())

    def render_batch(self, factors, num_sprites, success):
        del success
        return rasterize_cuda.render_rgb_batch(factors, num_sprites,
                                               **self._kwargs())

    def observation_spec(self):
        return ShapeDtype(self._image_size + (3,), torch.uint8)


# Familiar alias: reference users construct `PILRenderer`.
PILRenderer = ImageRenderer
