"""Factor distributions: batched samplers and contains-masks on tensors.

Counterpart of `spriteworld_tpu/core/distributions.py`, with its seven-node
algebra: `Continuous`, `Discrete`, `Mixture`, `Intersection`, `Product`,
`SetMinus` and `Selection`. Each node offers

  * ``sample_with_status(generator, shape) -> (dict[str, f32[*shape]],
    ok bool[*shape])`` — draws from an explicit `torch.Generator`, on that
    generator's device; ``sample`` drops the status;
  * ``contains(spec) -> bool tensor`` — vectorized over any batch of factor
    values, so one call masks all sprites of all lanes.

Semantics kept from the reference:
  * ``Continuous.contains`` is half-open ``[minval, maxval)``.
  * ``Continuous.sample`` casts through ``dtype`` (int dtypes truncate).
  * ``contains`` on a spec lacking the key raises KeyError.
  * Mixtures sample a component per element by probability; Intersection
    samples from ``index_for_sampling`` and rejects with the rest;
    SetMinus and Selection reject samples of their base.
  * Rejection is bounded by MAX_REJECTION_TRIES proposals per element;
    ``ok`` is False where the bound ran out or a nested rejection node
    reported exhaustion, which stops the outer loop at once (fail fast).

Sampling makes no host sync, so that a step can be captured in a CUDA
graph: categorical draws invert cached cumulative probabilities, a mixture
draws every component for every element and selects, and a rejection node
draws its first REJECTION_ROUNDS proposals of every element at once. Only
when an element is still pending after those does the node look at the
host (see `_rejection_sample` and `defer_rejection`).
"""

from __future__ import annotations

import abc
import contextlib
import contextvars
from typing import Dict, Sequence

import numpy as np
import torch

from spriteworld_torch import constants
from spriteworld_torch.utils import device as device_lib

Spec = Dict[str, torch.Tensor]

# Proposals per element before a rejection node gives up, as the JAX
# package's (the reference raises after as many).
MAX_REJECTION_TRIES = 100_000
# Proposals of every element a rejection node draws at once before it asks
# which elements are still pending. At the lowest acceptance rate of the
# rejecting configs (0.6, configs/examples/goal_finding_clustering.py's
# scale) an element is still pending after 32 of them with chance
# 0.4^32 = 2e-13 (PERF.md).
REJECTION_ROUNDS = 32

_DEFERRED = contextvars.ContextVar("spriteworld_rejection_deferred",
                                   default=None)


class Deferral:
    """What `defer_rejection` yields: the flag, and `nodes`, the rejection
    nodes that sampled inside the block (0: the flag cannot be set by a
    rerun of the same code)."""

    def __init__(self, flag: torch.Tensor):
        self.flag = flag
        self.nodes = 0


@contextlib.contextmanager
def defer_rejection(flag: torch.Tensor):
    """Within the block, a rejection node with elements still pending after
    its REJECTION_ROUNDS proposals sets `flag` (a bool[] tensor on the
    sampling device) and returns them with ok=False, instead of proposing
    on under a host check. Nothing then reads the device from the host, so
    the block can be captured in a CUDA graph. The caller reads `flag`
    afterwards and, where it is set, samples again outside this block from
    the same generator state: the first REJECTION_ROUNDS proposals are the
    same draws, and the host-checked ones continue them
    (`core.step_graph.StepGraph` re-runs such steps). Yields a `Deferral`
    that counts the rejection nodes the block ran."""
    deferral = Deferral(flag)
    token = _DEFERRED.set(deferral)
    try:
        yield deferral
    finally:
        _DEFERRED.reset(token)


def cumulative_probs(probs) -> np.ndarray:
    """float32 cumulative probabilities of `probs`, normalized."""
    p = np.asarray(probs, np.float64)
    return (np.cumsum(p) / p.sum()).astype(np.float32)


def categorical(generator: torch.Generator, cdf: np.ndarray, shape):
    """i64[*shape] indices drawn with cumulative probabilities `cdf`, by
    inverting the CDF at uniform draws: unlike `torch.multinomial`, no
    validity check on the host."""
    dev = generator.device
    u = torch.rand(shape, generator=generator, device=dev)
    idx = torch.bucketize(u, device_lib.constant(cdf, dev), right=True)
    return idx.clamp_(max=len(cdf) - 1)


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
        found no in-support sample."""

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
        self._cdf = None if probs is None else cumulative_probs(probs)

    def sample_with_status(self, generator, shape=()):
        dev = generator.device
        if self._cdf is None:
            idx = torch.randint(len(self.candidates), shape,
                                generator=generator, device=dev)
        else:
            idx = categorical(generator, self._cdf, shape)
        cands = device_lib.constant(self.candidates, dev)
        return ({self.key: cands[idx]},
                torch.ones(shape, dtype=torch.bool, device=dev))

    def contains(self, spec: Spec) -> torch.Tensor:
        self._require_keys(spec)
        v = spec[self.key]
        cands = device_lib.constant(self.candidates, v.device)
        return (v[..., None] == cands).any(-1)

    def to_str(self, indent):
        s = (f"<Discrete: key={self.key}, candidates={self.raw_candidates}, "
             f"probs={self.probs}>")
        return indent * "  " + s

    @property
    def keys(self):
        return frozenset([self.key])


def _same_keys_check(components, what):
    keys = components[0].keys
    for c in components[1:]:
        if c.keys != keys:
            raise ValueError(
                f"All {what} components must have the same key sets; got "
                f"{sorted(keys)} and {sorted(c.keys)}")
    return keys


def _proposal_rounds(generator, shape, rounds, propose, accept):
    """`rounds` proposals of every element, drawn at once; of each element's,
    the first that ends its do-while (accepted, or not ok: fail fast), else
    the last. Returns (spec, ok, pending bool[*shape]): pending where none
    of them ended the loop."""
    spec, ok = propose(generator, (rounds,) + shape)
    ok = ok.expand((rounds,) + shape)
    stop = accept(spec) | ~ok
    r = torch.arange(rounds, device=ok.device).view((rounds,)
                                                    + (1,) * len(shape))
    first = torch.where(stop, r, rounds - 1).amin(0, keepdim=True)

    def take(v):
        return v.expand((rounds,) + shape).gather(0, first).squeeze(0)

    return ({k: take(v) for k, v in spec.items()}, take(ok),
            ~stop.any(0))


def _rejection_sample(generator, shape, propose, accept):
    """Batched bounded rejection: propose until each element is accepted.

    `propose(generator, shape) -> (Spec, ok)`, `accept(Spec) -> bool`. Every
    element runs its own do-while loop of at most MAX_REJECTION_TRIES
    proposals, as in the JAX package's `_rejection_sample`; a proposal with
    ok=False (a nested rejection node that ran out) stops that element's
    loop: fail fast. Returns (spec, accept(spec) & ok).

    The proposals come in rounds of REJECTION_ROUNDS for every element,
    each element taking the first of a round that ends its loop, so the
    first round makes no host sync. Where an element is still pending after
    it, the node goes on with further rounds while the host finds one
    pending; inside `defer_rejection` it sets the flag instead and stops.
    """
    shape = tuple(shape)
    rounds = min(REJECTION_ROUNDS, MAX_REJECTION_TRIES)
    spec, ok, pending = _proposal_rounds(generator, shape, rounds, propose,
                                         accept)
    deferral = _DEFERRED.get()
    if deferral is not None:
        deferral.nodes += 1
        deferral.flag.logical_or_(pending.any())
        return spec, accept(spec) & ok
    tries = rounds
    while tries < MAX_REJECTION_TRIES and bool(pending.any()):
        n = min(REJECTION_ROUNDS, MAX_REJECTION_TRIES - tries)
        new, new_ok, new_pending = _proposal_rounds(generator, shape, n,
                                                    propose, accept)
        spec = {k: torch.where(pending, new[k], v) for k, v in spec.items()}
        ok = torch.where(pending, new_ok, ok)
        pending = pending & new_pending
        tries += n
    return spec, accept(spec) & ok


class Mixture(AbstractDistribution):
    """Mixture of same-keyed components with optional probabilities."""

    def __init__(self, components, probs=None):
        self.components = list(components)
        self.probs = (np.ones(len(self.components)) / len(self.components)
                      if probs is None else np.asarray(probs))
        self._keys = _same_keys_check(self.components, "Mixture")
        self._cdf = cumulative_probs(self.probs)

    def sample_with_status(self, generator, shape=()):
        shape = tuple(shape)
        idx = categorical(generator, self._cdf, shape)
        # Every component draws for every element and each element takes
        # its own component's draw (JAX's lax.switch under vmap).
        out, ok = None, None
        for i, c in enumerate(self.components):
            spec, c_ok = c.sample_with_status(generator, shape)
            spec = {k: v.to(torch.float32) for k, v in spec.items()}
            if out is None:
                out, ok = spec, c_ok
                continue
            sel = idx == i
            out = {k: torch.where(sel, spec[k], out[k]) for k in out}
            ok = torch.where(sel, c_ok, ok)
        return out, ok

    def contains(self, spec: Spec) -> torch.Tensor:
        results = torch.broadcast_tensors(
            *[c.contains(spec) for c in self.components])
        return torch.stack(results).any(0)

    def to_str(self, indent):
        inner = ",\n".join(c.to_str(indent + 2) for c in self.components)
        return (indent * "  " + "<Mixture:\n" + (indent + 1) * "  "
                + f"components=[\n{inner},\n" + (indent + 1) * "  " + "],\n"
                + (indent + 1) * "  " + f"probs={self.probs}>")

    @property
    def keys(self):
        return self._keys


class Intersection(AbstractDistribution):
    """Intersection via rejection sampling from one component."""

    def __init__(self, components, index_for_sampling: int = 0):
        self.components = list(components)
        self.index_for_sampling = index_for_sampling
        self._keys = _same_keys_check(self.components, "Intersection")

    def sample_with_status(self, generator, shape=()):
        proposal = self.components[self.index_for_sampling]
        return _rejection_sample(generator, shape,
                                 proposal.sample_with_status, self.contains)

    def contains(self, spec: Spec) -> torch.Tensor:
        results = torch.broadcast_tensors(
            *[c.contains(spec) for c in self.components])
        return torch.stack(results).all(0)

    def to_str(self, indent):
        inner = ",\n".join(c.to_str(indent + 2) for c in self.components)
        return (indent * "  " + "<Intersection:\n" + (indent + 1) * "  "
                + f"components=[\n{inner},\n" + (indent + 1) * "  " + "],\n"
                + (indent + 1) * "  "
                + f"index_for_sampling={self.index_for_sampling}>")

    @property
    def keys(self):
        return self._keys


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


class SetMinus(AbstractDistribution):
    """base \\ hold_out, via rejection sampling."""

    def __init__(self, base, hold_out):
        self.base = base
        self.hold_out = hold_out
        self._keys = base.keys
        if not hold_out.keys.issubset(self._keys):
            raise ValueError(
                f"Keys {sorted(hold_out.keys)} of hold_out is not a subset of "
                f"keys {sorted(base.keys)} of SetMinus base distribution.")

    def sample_with_status(self, generator, shape=()):
        return _rejection_sample(generator, shape,
                                 self.base.sample_with_status,
                                 lambda s: ~self.hold_out.contains(s))

    def contains(self, spec: Spec) -> torch.Tensor:
        return self.base.contains(spec) & ~self.hold_out.contains(spec)

    def to_str(self, indent):
        return (indent * "  " + "<SetMinus:\n" + (indent + 1) * "  "
                + f"base=\n{self.base.to_str(indent + 2)},\n"
                + (indent + 1) * "  "
                + f"hold_out=\n{self.hold_out.to_str(indent + 2)}>")

    @property
    def keys(self):
        return self._keys


class Selection(AbstractDistribution):
    """Samples of `base` accepted by `filtering` (subset-keyed)."""

    def __init__(self, base, filtering):
        self.base = base
        self.filtering = filtering
        self._keys = base.keys
        if not filtering.keys.issubset(self._keys):
            raise ValueError(
                f"Keys {sorted(filtering.keys)} of filtering is not a subset "
                f"of keys {sorted(base.keys)} of Selection base distribution.")

    def sample_with_status(self, generator, shape=()):
        return _rejection_sample(generator, shape,
                                 self.base.sample_with_status,
                                 self.filtering.contains)

    def contains(self, spec: Spec) -> torch.Tensor:
        return self.base.contains(spec) & self.filtering.contains(spec)

    def to_str(self, indent):
        return (indent * "  " + "<Selection:\n" + (indent + 1) * "  "
                + f"base=\n{self.base.to_str(indent + 2)},\n"
                + (indent + 1) * "  "
                + f"filtering=\n{self.filtering.to_str(indent + 2)}>")

    @property
    def keys(self):
        return self._keys
