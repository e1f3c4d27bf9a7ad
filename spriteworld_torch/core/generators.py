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

A `GenerateSprites` whose factor distribution is a tree of `Product`s over
`Continuous` and `Discrete` leaves draws its scene on CUDA keys in one
launch of the `lane_random` kernel's scene mode (`lane_random.draw_scene`),
bit for bit what its plain body draws; the route is decided once, from the
tree, when the generator is built (`_scene_table`). Any other tree, and
every scene on CPU keys, takes the plain body (`_sample_plain`).

A composite (`Shuffle`, `SampleGenerator`, `ChainGenerators`) whose whole
tree holds only those composites over such leaves draws its scene on CUDA
keys in one launch of the kernel's tree mode (`lane_random.draw_tree`),
drawing only the branch each lane chose, bit for bit what the plain bodies
draw; the route is decided when the composite is built (`_tree_table`), and
the nodes under a composite that takes it are not called. Other trees, and
CPU keys, take each composite's plain body (`_sample_plain`).
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


def _scene_table(factor_dist, num_sprites, kmax):
    """The `lane_random.scene_table` of a generator's scene, or None where
    the kernel cannot draw it: a tree that is not a `Product` of
    `Continuous` and `Discrete` leaves (nested `Product`s allowed, at most
    `lane_random.SCENE_MAX_DEPTH` deep) whose keys are factors and whose
    dtypes the kernel casts; a count that is neither an int nor a
    `RandInt`; no slot."""
    if type(num_sprites) is RandInt:
        count = (num_sprites.low, num_sprites.high)
    elif type(num_sprites) is int:
        count = num_sprites
    else:
        return None
    leaves = []

    def walk(dist, path):
        if type(dist) is distributions.Product:
            return len(path) < lane_random.SCENE_MAX_DEPTH and all(
                walk(c, path + (i,)) for i, c in enumerate(dist.components))
        if type(dist) is distributions.Continuous:
            dtype = np.dtype(dist.dtype).name
            if dtype not in lane_random.SCENE_CASTS:
                return False
            draw = ("uniform", dist.minval, dist.maxval, dtype)
        elif type(dist) is distributions.Discrete and len(dist.candidates):
            draw = (("randint", dist.candidates) if dist.probs is None else
                    ("choice", dist.candidates,
                     lane_random.cumulative(dist.probs)))
        else:
            return False
        if dist.key not in state_lib.FACTOR_INDEX:
            return False
        leaves.append((path, state_lib.FACTOR_INDEX[dist.key], draw))
        return True

    if (kmax < 1 or type(factor_dist) is not distributions.Product
            or not walk(factor_dist, ())):
        return None
    return lane_random.scene_table(count, leaves, state_lib.DEFAULT_FACTORS)


def _tree_table(gen):
    """The `lane_random.tree_table` of the composite `gen`'s whole tree, or
    None where the kernel cannot draw it: a node that is not exactly a
    `Shuffle`, `SampleGenerator`, `ChainGenerators` or a `GenerateSprites`
    with a scene table (`_scene_table`), or a tree past the kernel's limits
    (`lane_random.TREE_MAX_SLOTS`, `TREE_MAX_DEPTH`, `TREE_MAX_CHILDREN`)."""

    def walk(g):
        kind = type(g)
        if kind is GenerateSprites:
            return None if g._scene is None else ("leaf", g._scene,
                                                  g.max_sprites)
        if kind not in (Shuffle, ChainGenerators, SampleGenerator):
            return None
        subs = [walk(sub) for sub in ([g.gen] if kind is Shuffle
                                      else g.gens)]
        if any(sub is None for sub in subs):
            return None
        if kind is Shuffle:
            return ("shuffle", subs[0])
        if kind is ChainGenerators:
            return ("chain", subs)
        return ("sample", subs, g._cum)

    tree = walk(gen)
    if tree is None:
        return None
    try:
        return lane_random.tree_table(tree, state_lib.DEFAULT_FACTORS)
    except ValueError:  # past the kernel's limits
        return None


def _tree_or_plain(gen, key):
    """The composite `gen`'s scene of lane keys `key`: one launch of the
    kernel's tree mode where it has a table and the keys are on the card,
    else its plain body; the route counted into a capture's census."""
    if gen._tree is not None and key.is_cuda:
        profiling.route(type(gen).__name__, "tree")
        return lane_random.draw_tree(key, gen._tree)
    profiling.route(type(gen).__name__, "plain")
    return gen._sample_plain(key)


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
        self._scene = _scene_table(factor_dist, num_sprites, self.max_sprites)

    @profiling.node
    def sample_with_status(self, key):
        if self._scene is not None and key.is_cuda:
            profiling.route(type(self).__name__, "scene")
            return lane_random.draw_scene(key, self._scene, self.max_sprites)
        profiling.route(type(self).__name__, "plain")
        return self._sample_plain(key)

    def _sample_plain(self, key):
        """The scene of lane keys `key` int32[B, 2] in PyTorch operations:
        every tree's route on CPU keys, and the scene mode's twin."""
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
        self._tree = _tree_table(self)

    @profiling.node
    def sample_with_status(self, key):
        return _tree_or_plain(self, key)

    def _sample_plain(self, key):
        """The scene in PyTorch operations: every tree's route on CPU keys,
        and the tree mode's twin."""
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
        self._tree = _tree_table(self)

    @profiling.node
    def sample_with_status(self, key):
        return _tree_or_plain(self, key)

    def _sample_plain(self, key):
        """The scene in PyTorch operations: every tree's route on CPU keys,
        and the tree mode's twin."""
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
        self._tree = _tree_table(self)

    @profiling.node
    def sample_with_status(self, key):
        return _tree_or_plain(self, key)

    def _sample_plain(self, key):
        """The scene in PyTorch operations: every tree's route on CPU keys,
        and the tree mode's twin."""
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
