"""Factor distributions: batched samplers and contains-masks on tensors.

Counterpart of `spriteworld_tpu/core/distributions.py`, for the nodes the
goal-finding path uses: `Continuous`, `Discrete` and `Product`. Each node
offers

  * ``sample(generator, shape) -> dict[str, f32[*shape]]`` — draws from an
    explicit `torch.Generator`, on that generator's device;
  * ``contains(spec) -> bool tensor`` — vectorized over any batch of factor
    values, so one call masks all sprites of all lanes.

Semantics kept from the reference:
  * ``Continuous.contains`` is half-open ``[minval, maxval)``.
  * ``Continuous.sample`` casts through ``dtype`` (int dtypes truncate).
  * ``contains`` on a spec lacking the key raises KeyError.
"""

from __future__ import annotations

import abc
from typing import Dict, Sequence

import numpy as np
import torch

from spriteworld_torch import constants

Spec = Dict[str, torch.Tensor]


def _resolve(key: str, value):
    """Map shape names to ShapeType ids; pass everything else through."""
    if key == "shape" and isinstance(value, str):
        return float(constants.ShapeType[value].value)
    return value


class AbstractDistribution(abc.ABC):
    """Base class: a distribution over factor dicts ("specs")."""

    def sample(self, generator: torch.Generator, shape=()) -> Spec:
        """Sample a spec of f32 tensors of `shape` on generator's device."""
        return self.sample_with_status(generator, shape)[0]

    @abc.abstractmethod
    def sample_with_status(self, generator: torch.Generator, shape=()):
        """(spec, ok bool[*shape]) — ok=False where a bounded rejection loop
        found no in-support sample. The nodes here never reject."""

    @abc.abstractmethod
    def contains(self, spec: Spec) -> torch.Tensor:
        """Vectorized support check; broadcasts over batched spec values."""

    @abc.abstractmethod
    def to_str(self, indent: int) -> str:
        """Recursive description."""

    @property
    @abc.abstractmethod
    def keys(self) -> frozenset:
        """The set of factor keys this distribution produces."""

    def __str__(self):
        return self.to_str(indent=0)

    def _require_keys(self, spec: Spec):
        for k in self.keys:
            if k not in spec:
                raise KeyError(
                    f"key {k} is not in spec {sorted(spec)}, but must be to "
                    "evaluate containment.")


class Continuous(AbstractDistribution):
    """Uniform distribution on the half-open interval [minval, maxval)."""

    def __init__(self, key: str, minval, maxval, dtype="float32"):
        self.key = key
        self.minval = minval
        self.maxval = maxval
        self.dtype = dtype

    def sample_with_status(self, generator, shape=()):
        u = torch.rand(shape, generator=generator, device=generator.device)
        v = u * (self.maxval - self.minval) + self.minval
        # np.cast-style conversion: int dtypes truncate toward zero.
        v = v.to(getattr(torch, np.dtype(self.dtype).name)).to(torch.float32)
        return {self.key: v}, torch.ones(shape, dtype=torch.bool,
                                         device=generator.device)

    def contains(self, spec: Spec) -> torch.Tensor:
        self._require_keys(spec)
        v = spec[self.key]
        return (v >= self.minval) & (v < self.maxval)

    def to_str(self, indent):
        s = (f"<Continuous: key={self.key}, minval={self.minval}, "
             f"maxval={self.maxval}, dtype={self.dtype}>")
        return indent * "  " + s

    @property
    def keys(self):
        return frozenset([self.key])


class Discrete(AbstractDistribution):
    """Discrete distribution over a finite candidate set."""

    def __init__(self, key: str, candidates: Sequence, probs=None):
        self.key = key
        self.raw_candidates = list(candidates)
        self.candidates = np.asarray(
            [_resolve(key, c) for c in candidates], dtype=np.float32)
        self.probs = None if probs is None else np.asarray(probs)

    def sample_with_status(self, generator, shape=()):
        dev = generator.device
        n = len(self.candidates)
        numel = int(np.prod(shape))
        if self.probs is None:
            idx = torch.randint(n, (numel,), generator=generator, device=dev)
        else:
            p = torch.as_tensor(self.probs, dtype=torch.float32, device=dev)
            idx = torch.multinomial(p, numel, replacement=True,
                                    generator=generator)
        cands = torch.as_tensor(self.candidates, device=dev)
        return ({self.key: cands[idx].reshape(shape)},
                torch.ones(shape, dtype=torch.bool, device=dev))

    def contains(self, spec: Spec) -> torch.Tensor:
        self._require_keys(spec)
        v = spec[self.key]
        cands = torch.as_tensor(self.candidates, device=v.device)
        return (v[..., None] == cands).any(-1)

    def to_str(self, indent):
        s = (f"<Discrete: key={self.key}, candidates={self.raw_candidates}, "
             f"probs={self.probs}>")
        return indent * "  " + s

    @property
    def keys(self):
        return frozenset([self.key])


class Product(AbstractDistribution):
    """Product of components with disjoint key sets."""

    def __init__(self, components):
        self.components = list(components)
        all_keys = [c.keys for c in self.components]
        union = frozenset().union(*all_keys) if all_keys else frozenset()
        total = sum(len(k) for k in all_keys)
        if len(union) < total:
            raise ValueError(
                "All Product components must have different keys, yet there "
                f"are {total - len(union)} overlapping keys.")
        self._keys = union

    def sample_with_status(self, generator, shape=()):
        out: Spec = {}
        ok = torch.ones(shape, dtype=torch.bool, device=generator.device)
        for c in self.components:
            spec, c_ok = c.sample_with_status(generator, shape)
            out.update(spec)
            ok = ok & c_ok
        return out, ok

    def contains(self, spec: Spec) -> torch.Tensor:
        results = torch.broadcast_tensors(
            *[c.contains(spec) for c in self.components])
        return torch.stack(results).all(0)

    def to_str(self, indent):
        inner = ",\n".join(c.to_str(indent + 2) for c in self.components)
        return (indent * "  " + "<Product:\n" + (indent + 1) * "  "
                + f"components=[\n{inner},\n" + (indent + 1) * "  " + "]>")

    @property
    def keys(self):
        return self._keys
