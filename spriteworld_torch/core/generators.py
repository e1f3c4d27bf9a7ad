"""Scene generators: distributions -> packed batched sprite factor tensors.

Counterpart of `spriteworld_tpu/core/generators.py`, for the generators the
goal-finding and clustering paths use. A generator has a static capacity
``max_sprites`` and ``sample_with_status(generator, batch) -> (factors
f32[B, max_sprites, 10], num i32[B], ok bool[B])``, drawing from an
explicit `torch.Generator`.

Packing invariant: live sprites occupy slots [0, num); slot order is z-order
(higher slot = foreground). Dead slots hold the default factor row so
downstream masked math stays finite.
"""

from __future__ import annotations

import torch

from spriteworld_torch.core import state as state_lib


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

    def sample(self, generator: torch.Generator, batch: int):
        """(factors f32[B, max_sprites, 10], num i32[B])."""
        return self.sample_with_status(generator, batch)[:2]

    def sample_with_status(self, generator: torch.Generator, batch: int):
        """(factors, num, ok bool[B]); ok=False flags a scene with a sprite
        whose rejection sampling exhausted its bound."""
        if type(self).sample is SpriteGenerator.sample:
            raise NotImplementedError(
                "SpriteGenerator subclasses must implement sample() or "
                "sample_with_status().")
        factors, num = self.sample(generator, batch)
        return factors, num, torch.ones(batch, dtype=torch.bool,
                                        device=factors.device)


class GenerateSprites(SpriteGenerator):
    """Sample `num_sprites` iid sprites from a factor distribution."""

    def __init__(self, factor_dist, num_sprites: int = 1):
        if not isinstance(num_sprites, int):
            raise TypeError(
                "GenerateSprites takes a fixed int sprite count; random "
                "counts (RandInt) are ROADMAP Queue 1 item 10")
        self.factor_dist = factor_dist
        self.num_sprites = num_sprites
        self.max_sprites = num_sprites

    def sample_with_status(self, generator, batch: int):
        dev = generator.device
        kmax = self.max_sprites
        specs, ok = self.factor_dist.sample_with_status(
            generator, (batch, kmax))
        factors = state_lib.default_factors((batch, kmax), dev)
        for name, values in specs.items():
            factors[..., state_lib.FACTOR_INDEX[name]] = values.to(
                torch.float32)
        num = torch.full((batch,), self.num_sprites, dtype=torch.int32,
                         device=dev)
        return factors, num, ok.all(-1)


class ChainGenerators(SpriteGenerator):
    """Concatenate generators ('AND'). Order preserved."""

    def __init__(self, *gens: SpriteGenerator):
        self.gens = gens
        self.max_sprites = sum(g.max_sprites for g in gens)

    def sample_with_status(self, generator, batch: int):
        parts, valids = [], []
        ok = torch.ones(batch, dtype=torch.bool, device=generator.device)
        for g in self.gens:
            f, n, g_ok = g.sample_with_status(generator, batch)
            parts.append(f)
            idx = torch.arange(g.max_sprites, device=f.device)
            valids.append(idx < n[:, None])
            ok = ok & g_ok
        factors, num = _pack(torch.cat(parts, 1), torch.cat(valids, 1))
        return factors, num, ok


class Shuffle(SpriteGenerator):
    """Randomize the z-order of the generated sprites."""

    def __init__(self, gen: SpriteGenerator):
        self.gen = gen
        self.max_sprites = gen.max_sprites

    def sample_with_status(self, generator, batch: int):
        factors, num, ok = self.gen.sample_with_status(generator, batch)
        k = self.max_sprites
        # Uniform keys for live rows, +inf for dead rows: sorting yields a
        # uniform permutation of the live prefix, dead rows stay at the back.
        r = torch.rand((batch, k), generator=generator,
                       device=generator.device)
        live = torch.arange(k, device=r.device) < num[:, None]
        r = torch.where(live, r, torch.full_like(r, torch.inf))
        order = torch.sort(r, dim=-1, stable=True).indices
        return (factors.gather(
            -2, order[..., None].expand(-1, -1, factors.shape[-1])), num, ok)


# Functional aliases mirroring the reference module-level API.
def generate_sprites(factor_dist, num_sprites: int = 1):
    return GenerateSprites(factor_dist, num_sprites)


def chain_generators(*gens):
    return ChainGenerators(*gens)


def shuffle(gen):
    return Shuffle(gen)
