"""The comparison that decides `correct`: the program's answers against the
plain reference (`perfbench/reference/`).

What is compared is what the timed path produced, recorded by the traffic
loop (`perfbench/loops/<loop>.py`, whose `check` compares its own records
with the helpers here). Three numbers, each a count of values that differ:
the observation's values (`observation_values_off`: an image's bytes, or
each leaf of a dict of arrays), the rewards and step types
(`timestep_values_off`; NaN equals NaN) and the state's factors, counts,
flags and keys and the action key (`state_values_off`). Each comparison is
exact, and each limit (`limits` in the configuration's file) is 0. The
control (`control=True` in a loop's `check`) puts the reference computed
in bfloat16, the precision below the configurations' float32 state, in the
program's place.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from typing import Dict, List

import numpy as np

from perfbench.reference import engine

NAMES = ("observation_values_off", "timestep_values_off",
         "state_values_off")
MASK = 0xFFFFFFFF


def reference_module(path: pathlib.Path):
    """The configuration's reference module (`build(precision) -> Env`),
    loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Tally:
    """Values off in each class of `NAMES`; answers compared and answers
    with a value off (an answer is one lane's reset or step, or a lane's
    state at a call's end); the threefry blocks the reference computed and
    its lane steps."""

    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(NAMES, 0))
    answers: int = 0
    answers_off: int = 0
    blocks: int = 0
    lane_steps: int = 0

    def off(self, name: str, got, want) -> np.ndarray:
        """Counts the values of `got` that differ from `want` (same shape,
        leading axes [T, L] or [L]) under `name`; returns them."""
        g, w = np.asarray(got), np.asarray(want)
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            g, w = g.astype(np.float32), w.astype(np.float32)
            diff = ~((g == w) | (np.isnan(g) & np.isnan(w)))
        else:
            diff = g != w
        self.counts[name] += int(diff.sum())
        return diff

    def answer(self, off_any):
        off_any = np.asarray(off_any, bool)
        self.answers += off_any.size
        self.answers_off += int(off_any.sum())


def leaves(tree) -> List[np.ndarray]:
    """The arrays of an observation (an array, or a dict of arrays by
    sorted key)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    return [np.asarray(tree)]


def stack(trees):
    """One observation of stacked arrays from a list of observations."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def observation_off(tally: Tally, got, want, lead: int) -> np.ndarray:
    """Counts the observation's values off, leaf by leaf; returns bool
    over the `lead` leading axes, an answer with any off."""
    g, w = leaves(got), leaves(want)
    shape = np.asarray(w[0]).shape[:lead]
    off = np.zeros(shape, bool)
    for a, b in zip(g, w, strict=True):
        b = np.asarray(b)
        # The program may hand a leaf flattened ([T, L, H*W*3]).
        diff = tally.off("observation_values_off",
                         np.asarray(a).reshape(b.shape), b)
        off |= diff.reshape(shape + (-1,)).any(-1)
    return off


def words(keys) -> np.ndarray:
    """Key words as uint32, from the program's int32 or the reference's."""
    return (np.asarray(keys).astype(np.int64) & MASK).astype(np.uint32)


def as_state(d: dict) -> engine.State:
    return engine.State(
        factors=np.array(d["factors"], np.float32),
        num=np.array(d["num"], np.int32),
        step_count=np.array(d["step_count"], np.int32),
        reset_next=np.array(d["reset_next"], bool),
        key=words(d["key"]))


def state_off(tally: Tally, got: dict, want: engine.State) -> np.ndarray:
    """Counts state values off; returns bool[L], a lane with any off."""
    lanes = len(want.num)
    per_lane = np.zeros(lanes, bool)
    for name in engine.State.FIELDS:
        g, w = np.asarray(got[name]), getattr(want, name)
        if name == "key":
            g = words(g)
        diff = tally.off("state_values_off", g.reshape(lanes, -1),
                         w.reshape(lanes, -1))
        per_lane |= diff.any(1)
    return per_lane


def verdict(tally: Tally, limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) of a tally against the limits."""
    rows = [(n, tally.counts[n], limits[n]) for n in NAMES]
    return all(v <= lim for _, v, lim in rows), rows


def sample_indices(rng: np.random.Generator, n: int, k: int) -> List[int]:
    """Up to k indices of range(n) drawn by `rng`, the first and the last
    always among them."""
    if n <= 0:
        return []
    pick = {0, n - 1}
    rest = np.arange(1, n - 1)
    extra = min(max(k - len(pick), 0), len(rest))
    if extra:
        pick.update(int(i) for i in rng.choice(rest, extra, replace=False))
    return sorted(pick)
