"""Scene generators: distributions -> packed batched sprite factor tensors.

Counterpart of `spriteworld_tpu/core/generators.py`. A generator has a
static capacity ``max_sprites`` and ``sample_with_status(key) -> (factors
f32[B, max_sprites, 10], num i32[B], ok bool[B])``, one scene a lane key of
`key` int32[B, 2] (`ops.lane_random`), each split as the JAX generator
splits its key.

Packing invariant: live sprites occupy slots [0, num); slot order is z-order
(higher slot = foreground). Dead slots hold the default factor row so
downstream masked math stays finite. Random sprite counts are `RandInt`s
(or `(low, high)` tuples), drawn per lane within the static capacity.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from spriteworld_torch.core import distributions
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import lane_random
from spriteworld_torch.utils import profiling


class RandInt:
    """Uniform random integer in [low, high): a per-lane sprite count."""

    def __init__(self, low: int, high: int):
        if high <= low:
            raise ValueError(f"need high > low, got [{low}, {high})")
        self.low = int(low)
        self.high = int(high)

    @property
    def max_value(self) -> int:
        return self.high - 1

    def __call__(self, key: torch.Tensor):
        """i32[B] of counts, one a lane key of `key` int32[B, 2]."""
        return lane_random.randint(key, 1, self.low, self.high)[..., 0]


NumSprites = Union[int, Tuple[int, int], RandInt]


def _pack(factors: torch.Tensor, valid: torch.Tensor):
    """Stable-partition live rows [B, K] to the front, preserving order."""
    k = factors.shape[-2]
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    packed = factors.gather(-2, order[..., None].expand(-1, -1, factors.shape[-1]))
    num = valid.sum(-1).to(torch.int32)
    # Reset dead rows to defaults.
    alive = torch.arange(k, device=factors.device) < num[:, None]
    default = state_lib.default_factors((1, 1), factors.device)
    packed = torch.where(alive[..., None], packed, default)
    return packed, num


class SpriteGenerator:
    """Base: batched scene sampler with static capacity."""

    max_sprites: int

    def sample(self, key: torch.Tensor):
        """(factors f32[B, max_sprites, 10], num i32[B]) of lane keys
        `key` int32[B, 2]."""
        return self.sample_with_status(key)[:2]

    @profiling.node
    def sample_with_status(self, key: torch.Tensor):
        """(factors, num, ok bool[B]); ok=False flags a scene with a sprite
        whose rejection sampling exhausted its bound."""
        if type(self).sample is SpriteGenerator.sample:
            raise NotImplementedError(
                "SpriteGenerator subclasses must implement sample() or "
                "sample_with_status().")
        factors, num = self.sample(key)
        return factors, num, torch.ones(key.shape[0], dtype=torch.bool,
                                        device=factors.device)


class GenerateSprites(SpriteGenerator):
    """Sample `num_sprites` iid sprites from a factor distribution; a
    `RandInt` (or a `(low, high)` tuple) draws the count per lane."""

    def __init__(self, factor_dist, num_sprites: NumSprites = 1):
        if isinstance(num_sprites, tuple):
            num_sprites = RandInt(*num_sprites)
        self.factor_dist = factor_dist
        self.num_sprites = num_sprites
        self.max_sprites = (num_sprites if isinstance(num_sprites, int)
                            else num_sprites.max_value)

    @profiling.node
    def sample_with_status(self, key):
        dev, batch = key.device, key.shape[0]
        kmax = self.max_sprites
        keys = lane_random.split(key, 2)  # the count's key, the sprites'
        if isinstance(self.num_sprites, int):
            num = torch.full((batch,), self.num_sprites, dtype=torch.int32,
                             device=dev)
        else:
            num = self.num_sprites(keys[:, 0])
        specs, ok = self.factor_dist.sample_with_status(
            lane_random.split(keys[:, 1], kmax))
        factors = state_lib.default_factors((batch, kmax), dev)
        for name, values in specs.items():
            factors[..., state_lib.FACTOR_INDEX[name]] = values.to(
                torch.float32)
        alive = torch.arange(kmax, device=dev) < num[:, None]
        factors = torch.where(alive[..., None], factors,
                              state_lib.default_factors((1, 1), dev))
        # Only live slots count: a dead slot's discarded draw cannot poison
        # the scene status.
        return factors, num, (ok | ~alive).all(-1)


class ChainGenerators(SpriteGenerator):
    """Concatenate generators ('AND'). Order preserved."""

    def __init__(self, *gens: SpriteGenerator):
        self.gens = gens
        self.max_sprites = sum(g.max_sprites for g in gens)

    @profiling.node
    def sample_with_status(self, key):
        parts, valids = [], []
        ok = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
        keys = lane_random.split(key, len(self.gens))
        for i, g in enumerate(self.gens):
            f, n, g_ok = g.sample_with_status(keys[:, i])
            parts.append(f)
            idx = torch.arange(g.max_sprites, device=f.device)
            valids.append(idx < n[:, None])
            ok = ok & g_ok
        factors, num = _pack(torch.cat(parts, 1), torch.cat(valids, 1))
        return factors, num, ok


class SampleGenerator(SpriteGenerator):
    """Sample one of several generators per lane ('OR'), with optional
    probabilities; scenes are padded to the largest capacity with default
    rows, as the JAX package pads them."""

    def __init__(self, gens: Sequence[SpriteGenerator], p=None):
        self.gens = list(gens)
        self.p = None if p is None else np.asarray(p)
        self._cum = None if p is None else lane_random.cumulative(p)
        self.max_sprites = max(g.max_sprites for g in self.gens)

    @profiling.node
    def sample_with_status(self, key):
        dev, batch = key.device, key.shape[0]
        keys = lane_random.split(key, 2)  # the choice's key, the scene's
        idx = distributions.choose(keys[:, 0], len(self.gens), self._cum)
        # Every generator draws for every lane from the scene key and each
        # lane takes its own generator's scene (JAX's lax.switch under
        # vmap).
        factors = num = ok = None
        for i, g in enumerate(self.gens):
            f, n_i, ok_i = g.sample_with_status(keys[:, 1])
            pad = self.max_sprites - g.max_sprites
            if pad:
                f = torch.cat(
                    [f, state_lib.default_factors((batch, pad), dev)], 1)
            if factors is None:
                factors, num, ok = f, n_i, ok_i
                continue
            sel = idx == i
            factors = torch.where(sel[:, None, None], f, factors)
            num = torch.where(sel, n_i, num)
            ok = torch.where(sel, ok_i, ok)
        return factors, num, ok


class Shuffle(SpriteGenerator):
    """Randomize the z-order of the generated sprites."""

    def __init__(self, gen: SpriteGenerator):
        self.gen = gen
        self.max_sprites = gen.max_sprites

    @profiling.node
    def sample_with_status(self, key):
        keys = lane_random.split(key, 2)  # the scene's key, the order's
        factors, num, ok = self.gen.sample_with_status(keys[:, 0])
        k = self.max_sprites
        # Uniform keys for live rows, +inf for dead rows: sorting yields a
        # uniform permutation of the live prefix, dead rows stay at the back.
        r = lane_random.uniform(keys[:, 1], k)
        live = torch.arange(k, device=r.device) < num[:, None]
        r = torch.where(live, r, torch.full_like(r, torch.inf))
        order = torch.sort(r, dim=-1, stable=True).indices
        return (factors.gather(
            -2, order[..., None].expand(-1, -1, factors.shape[-1])), num, ok)


# Functional aliases mirroring the reference module-level API.
def generate_sprites(factor_dist, num_sprites: NumSprites = 1):
    return GenerateSprites(factor_dist, num_sprites)


def chain_generators(*gens):
    return ChainGenerators(*gens)


def sample_generator(gens, p=None):
    return SampleGenerator(gens, p)


def shuffle(gen):
    return Shuffle(gen)
