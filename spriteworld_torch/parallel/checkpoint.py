"""Checkpoint/resume of simulation state: tensors keyed by field path.

Counterpart of `spriteworld_tpu/parallel/checkpoint.py`, without orbax: the
whole simulation (factor tensors, step counters, flags, random keys,
batched over lanes) is a tree of tensors, and `save_state` writes its
leaves into one `.npz` keyed by their path in the tree, spelled as
`jax.tree_util.keystr` spells it (`.factors` for a dataclass field,
`['env_state']` for a dict key, `[0]` for a sequence index). The state
holds every lane's random key (`.key`, int32[B, 2]: the words of a
threefry key), so a restored state resumes the same trajectories, and with
the runner's action key the same run. The recommended runner checkpoint
is::

    ckpt = {"env_state": state, "episode_returns": runner.episode_returns,
            "action_key": runner.action_key}
    save_state(path, ckpt)
    ...
    restored = restore_state(path, like=ckpt)
    runner.episode_returns = restored["episode_returns"]
    runner.action_key = restored["action_key"]

so per-episode returns of episodes in flight at save time survive a
kill-and-resume. Lanes are global data: a state gathered over a mesh's
ranks (`EnvSharding.gather`) restores under any other mesh shape, each rank
taking its slice (`EnvSharding.shard`), and the run goes on as it would
have.

Forward migration, as in the JAX package: leaves are keyed by path, so a
checkpoint taken before a state field existed restores cleanly — missing
leaves are filled from `like` with a warning, extra leaves are ignored with
a warning. A checkpoint written before the state held keys (its generator
states are ignored) therefore restores with `like`'s keys. A JAX package
`.npz` restores every field, its `.key` (uint32 key data, the words
`jax.random.key_data` gives) as the lanes' keys.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return not (isinstance(x, (dict, list, tuple))
                or dataclasses.is_dataclass(x))


def _children(tree) -> List[Tuple[str, Any]]:
    """(path suffix, child) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return [(f".{f.name}", getattr(tree, f.name))
            for f in dataclasses.fields(tree)]


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    if _is_leaf(tree):
        return [(path, tree)]
    return [item for suffix, child in _children(tree)
            for item in _flatten(child, path + suffix)]


def _rebuild(tree, fn: Callable, path: str = ""):
    """`tree` with each leaf replaced by fn(path, leaf)."""
    if _is_leaf(tree):
        return fn(path, tree)
    new = {suffix: _rebuild(child, fn, path + suffix)
           for suffix, child in _children(tree)}
    if isinstance(tree, dict):
        return {k: new[f"[{k!r}]"] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[f"[{i}]"] for i in range(len(tree)))
    return dataclasses.replace(
        tree, **{f.name: new[f".{f.name}"]
                 for f in dataclasses.fields(tree)})


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore_leaf(value: np.ndarray, like):
    """`value` in the type, dtype and device of `like`. Unsigned words
    restored into a signed tensor of their width keep their bits (JAX's
    uint32 key data into the port's int32 keys)."""
    if isinstance(like, torch.Tensor):
        value = np.asarray(value)
        if value.dtype.kind == "u" and like.dtype.is_signed \
                and not like.dtype.is_floating_point \
                and value.dtype.itemsize == like.element_size():
            value = np.ascontiguousarray(value).view(
                value.dtype.str.replace("u", "i"))
        return torch.as_tensor(value, device=like.device).to(like.dtype)
    if isinstance(like, np.ndarray):
        return np.asarray(value).astype(like.dtype)
    return type(like)(np.asarray(value).item())


def save_state(path: str, state: Any, *, force: bool = True) -> None:
    """Write a tree of tensors (e.g. an EnvState, or a dict holding one and
    the runner's action key) to `path`.npz. With `force=False` an existing
    `path`.npz is not overwritten: that raises FileExistsError, as orbax
    refuses in the JAX package."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path + ".npz"):
        raise FileExistsError(f"Checkpoint {path}.npz exists; pass "
                              "force=True to overwrite it.")
    np.savez(path + ".npz", **{p: _to_numpy(x) for p, x in _flatten(state)})


def _fill_from_like(stored: dict, like: Any, source: str) -> Any:
    """Rebuild `like` from a path->array dict; missing leaves keep their
    `like` value (defaults), extra stored leaves are ignored."""
    paths = [p for p, _ in _flatten(like)]
    missing = [p for p in paths if p not in stored]
    if missing:
        warnings.warn(
            f"Checkpoint {source} predates state field(s) {missing}; "
            "restoring them from the provided `like` values.")
    extra = sorted(set(stored) - set(paths))
    if extra:
        warnings.warn(
            f"Checkpoint {source} contains unknown field(s) {extra}; "
            "ignored.")
    return _rebuild(like, lambda p, leaf: (
        _restore_leaf(stored[p], leaf) if p in stored else leaf))


def restore_state(path: str, like: Any) -> Any:
    """Restore a tree saved by `save_state` (or by the JAX package's npz
    form).

    `like` provides the structure, dtypes and devices (e.g. a freshly reset
    state of the same env and batch). Fields absent from the checkpoint are filled from `like` with a
    warning instead of failing. A legacy positional checkpoint (every array
    named `arr_<i>`) restores in `like`'s leaf order where the leaf counts
    match, and raises ValueError where they do not.
    """
    path = os.path.abspath(path)
    with np.load(path + ".npz") as data:
        stored = {k: data[k] for k in data.files}
    if stored and all(k.startswith("arr_") for k in stored):
        paths = [p for p, _ in _flatten(like)]
        if len(stored) != len(paths):
            raise ValueError(
                f"Positional (legacy) checkpoint {path}.npz has "
                f"{len(stored)} leaves but the target state has "
                f"{len(paths)}; cannot restore safely.")
        by_path = {p: stored[f"arr_{i}"] for i, p in enumerate(paths)}
        return _rebuild(like, lambda p, leaf: _restore_leaf(by_path[p], leaf))
    return _fill_from_like(stored, like, source=f"{path}.npz")
