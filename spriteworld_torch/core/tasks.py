"""Tasks as batched reward/success functions over the factor state.

Counterpart of `spriteworld_tpu/core/tasks.py`: `NoReward`,
`FindGoalPosition`, `Clustering`, `MetaAggregated` and `task_valid`. Each
task maps ``(factors f32[B, K, 10], num_sprites i32[B])`` to a per-lane
reward f32[B] and success bool[B].

Contract quirks kept: FindGoalPosition returns NaN when no sprite passes
the filter, and its success is then vacuously True (``all([])``).
Clustering scores 1/davies_bouldin and assigns each sprite to the FIRST
cluster distribution containing it. MetaAggregated combines subtask rewards
with NaN-ignoring aggregators and adds `terminate_bonus * success` (a zero
bonus adds nothing, so its success is not computed for the reward). Its
"sum" adds the subtasks' rewards in their order, ((r_0 + r_1) + r_2) + ...,
with elementwise adds (`ops.clustering.ordered_sum`), the same bits on the
CPU and the card; FindGoalPosition's dense reward folds its sprites in
slot order the same way.

Evaluation: an `Evaluator` computes a task's reward, success and validity
where the step needs them. For a tree that `task_table` describes (every
node a NoReward, FindGoalPosition, Clustering or MetaAggregated with the
"sum", "max" or "min" aggregator, every filter and cluster a tree of the
seven distributions over factor columns) CUDA factors take one launch of
`ops.task_eval`, the same bits as the methods; every other tree, and
every CPU tensor, takes the task's own methods.

Tracing: on the methods' route each subtask of a MetaAggregated runs in
its own span, `env.task.<Class>#<i>` (i its place among the subtasks),
and each task method counts its calls into the census of a graph being
captured (`utils.profiling.evaluation`); each evaluation counts its route
there too (`utils.profiling.task_route`).

Goal distance: each product of ``sum(w * (pos - goal)**2)`` is rounded once
before the sum, as the TPU computes it (Mosaic and XLA on the TPU do not
contract a multiply and an add into one FMA; XLA on the CPU does, so the
JAX package on the CPU can differ from the port by an ulp off the grid).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import clustering as clustering_ops
from spriteworld_torch.ops import task_eval
from spriteworld_torch.ops.task_eval import REWARD, SUCCESS, VALID
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling


class NoReward:
    """Zero reward, never succeeds."""

    @profiling.evaluation
    def reward(self, factors, num_sprites):
        return torch.zeros(factors.shape[0], device=factors.device)

    @profiling.evaluation
    def success(self, factors, num_sprites):
        return torch.zeros(factors.shape[0], dtype=torch.bool,
                           device=factors.device)


class FindGoalPosition:
    """Bring all (filtered) sprites within a distance of a goal position."""

    def __init__(self,
                 filter_distrib=None,
                 goal_position=(0.5, 0.5),
                 terminate_distance: float = 0.05,
                 terminate_bonus: float = 0.0,
                 weights_dimensions=(1, 1),
                 sparse_reward: bool = False,
                 raw_reward_multiplier: float = 50):
        self._filter_distrib = filter_distrib
        self._goal_position = np.asarray(goal_position, dtype=np.float32)
        self._terminate_bonus = terminate_bonus
        self._terminate_distance = terminate_distance
        self._sparse_reward = sparse_reward
        self._weights_dimensions = np.asarray(
            weights_dimensions, dtype=np.float32)
        self._raw_reward_multiplier = raw_reward_multiplier

    def _per_sprite_rewards(self, factors):
        """f32[B, K]: mult * (terminate_distance - weighted goal distance)."""
        dev = factors.device
        delta = factors[..., 0:2] - device_lib.constant(
            self._goal_position, dev)
        weights = device_lib.constant(self._weights_dimensions, dev)
        # Each product rounded once (see the module docstring); float64 sqrt
        # rounds to the correctly rounded float32 value, which torch's
        # vectorized float32 sqrt on the CPU does not always give.
        dist = torch.sqrt((weights * delta ** 2).sum(-1).double()).float()
        return self._raw_reward_multiplier * (self._terminate_distance - dist)

    def filter_mask(self, factors, num_sprites):
        """bool[B, K]: live sprites that pass the filter."""
        k = factors.shape[-2]
        alive = torch.arange(k, device=factors.device) < num_sprites[:, None]
        if self._filter_distrib is None:
            return alive
        return alive & self._filter_distrib.contains(
            state_lib.factors_to_dict(factors))

    @profiling.evaluation
    def reward(self, factors, num_sprites):
        rewards = self._per_sprite_rewards(factors)
        mask = self.filter_mask(factors, num_sprites)
        zero = torch.zeros_like(rewards)
        dense = clustering_ops.ordered_sum(torch.where(mask, rewards, zero),
                                           -1)
        succeeded = torch.where(mask, rewards, zero + torch.inf).ge(0).all(-1)
        bonus = torch.where(succeeded, self._terminate_bonus + dense,
                            torch.zeros_like(dense))
        shaped = torch.where(
            succeeded, bonus,
            torch.zeros_like(dense) if self._sparse_reward else dense)
        return torch.where(mask.any(-1), shaped,
                           torch.full_like(shaped, torch.nan))

    @profiling.evaluation
    def success(self, factors, num_sprites):
        rewards = self._per_sprite_rewards(factors)
        mask = self.filter_mask(factors, num_sprites)
        # Vacuously True on an empty filter, like `all([])`.
        return torch.where(mask, rewards,
                           torch.full_like(rewards, torch.inf)).ge(0).all(-1)


class Clustering:
    """Cluster sprites; reward from the inverse Davies-Bouldin index."""

    def __init__(self,
                 cluster_distribs: Sequence,
                 termination_threshold: float = 2.5,
                 terminate_bonus: float = 0.0,
                 sparse_reward: bool = False,
                 reward_range: float = 10):
        self._cluster_distribs = list(cluster_distribs)
        self._num_clusters = len(self._cluster_distribs)
        self._termination_threshold = termination_threshold
        self._terminate_bonus = terminate_bonus
        self._sparse_reward = sparse_reward
        self._reward_range = reward_range

    @profiling.evaluation
    def membership(self, factors, num_sprites):
        """bool[B, K, C]: live sprite k belongs to the FIRST cluster whose
        distribution contains it."""
        spec = state_lib.factors_to_dict(factors)
        contains = torch.stack(
            [d.contains(spec) for d in self._cluster_distribs], -1)
        first = contains.to(torch.uint8).argmax(-1)  # first True wins
        k = factors.shape[-2]
        alive = torch.arange(k, device=factors.device) < num_sprites[:, None]
        one_hot = torch.arange(self._num_clusters,
                               device=factors.device) == first[..., None]
        return one_hot & (contains.any(-1) & alive)[..., None]

    def _metric(self, factors, num_sprites):
        member = self.membership(factors, num_sprites)
        return 1.0 / clustering_ops.davies_bouldin_index(factors[..., 0:2],
                                                         member)

    @profiling.evaluation
    def reward(self, factors, num_sprites):
        metric = self._metric(factors, num_sprites)
        dense = (metric - self._termination_threshold) \
            * self._reward_range / 2.0
        succeeded = metric >= self._termination_threshold
        zero = torch.zeros_like(dense)
        bonus = torch.where(succeeded, self._terminate_bonus + dense, zero)
        return torch.where(succeeded, bonus,
                           zero if self._sparse_reward else dense)

    @profiling.evaluation
    def success(self, factors, num_sprites):
        return self._metric(factors, num_sprites) \
            >= self._termination_threshold

    @profiling.evaluation
    def valid(self, factors, num_sprites):
        """True exactly on sklearn davies_bouldin_score's domain,
        ``1 < n_labels < n_samples``: n_samples counts the sprites assigned
        to any cluster, n_labels the populated clusters. With all-singleton
        clusters the metric is 1/0 = inf and sklearn raises, so that state
        is invalid too."""
        member = self.membership(factors, num_sprites)
        n_labels = member.any(-2).sum(-1)
        n_samples = member.sum((-2, -1))
        return (n_labels >= 2) & (n_labels < n_samples)


def _nan_extreme(x, largest: bool):
    """NaN-ignoring max or min over dim 0; NaN where every entry is NaN."""
    fill = -torch.inf if largest else torch.inf
    clean = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
    out = clean.amax(0) if largest else clean.amin(0)
    return torch.where(torch.isnan(x).all(0), torch.full_like(out, torch.nan),
                       out)


_AGGREGATORS = {
    "sum": lambda x: clustering_ops.ordered_sum(
        torch.where(torch.isnan(x), 0.0, x), 0),
    "max": lambda x: _nan_extreme(x, True),
    "min": lambda x: _nan_extreme(x, False),
    "mean": lambda x: torch.nanmean(x, 0),
}
_CRITERIA = {"all": lambda x: x.all(0), "any": lambda x: x.any(0)}


class MetaAggregated:
    """NaN-aware aggregation of several subtasks."""

    def __init__(self,
                 subtasks: Sequence,
                 reward_aggregator: str = "sum",
                 termination_criterion: str = "all",
                 terminate_bonus: float = 0.0):
        if reward_aggregator not in _AGGREGATORS:
            raise ValueError(
                f"Unknown reward_aggregator. {reward_aggregator} not in "
                f"{sorted(_AGGREGATORS)}")
        if termination_criterion not in _CRITERIA:
            raise ValueError(
                f"Unknown termination_criterion. {termination_criterion} "
                f"not in {sorted(_CRITERIA)}")
        self._subtasks = list(subtasks)
        self._aggregator_name = reward_aggregator
        self._criterion_name = termination_criterion
        self._reward_aggregator = _AGGREGATORS[reward_aggregator]
        self._termination_criterion = _CRITERIA[termination_criterion]
        self._terminate_bonus = terminate_bonus
        self._spans = [f"env.task.{type(t).__name__}#{i}"
                       for i, t in enumerate(self._subtasks)]

    def _each(self, fn):
        """[fn(subtask)] in the subtasks' order, each in its span."""
        out = []
        for span, t in zip(self._spans, self._subtasks):
            with profiling.annotate(span):
                out.append(fn(t))
        return out

    @profiling.evaluation
    def reward(self, factors, num_sprites):
        agg = self._reward_aggregator(torch.stack(
            self._each(lambda t: t.reward(factors, num_sprites))))
        if not self._terminate_bonus:
            return agg
        return agg + self._terminate_bonus * self.success(
            factors, num_sprites).to(agg.dtype)

    @profiling.evaluation
    def success(self, factors, num_sprites):
        return self._termination_criterion(torch.stack(
            self._each(lambda t: t.success(factors, num_sprites))))

    @profiling.evaluation
    def valid(self, factors, num_sprites):
        return torch.stack(self._each(
            lambda t: task_valid(t, factors, num_sprites))).all(0)


def task_valid(task, factors, num_sprites) -> torch.Tensor:
    """bool[B]: whether the task's reward/success are defined on each lane.

    Tasks without a `valid` method (NoReward, FindGoalPosition, whose NaN
    rewards are contractual) are always valid; Clustering is valid on
    sklearn's domain; MetaAggregated where all its subtasks are.
    """
    fn = getattr(task, "valid", None)
    if fn is None:
        return torch.ones(factors.shape[0], dtype=torch.bool,
                          device=factors.device)
    return fn(factors, num_sprites)


def _number(x) -> bool:
    """Whether `x` enters torch's arithmetic as a Python scalar (an int or
    a float), which a float32 operation takes as float32(x)."""
    return isinstance(x, (int, float))


def _predicate(dist, programs) -> Optional[int]:
    """Appends the predicate program of `dist` (a filter or a cluster: what
    its `contains` computes on one sprite's factors) to `programs`;
    returns its index, or None where a node is not one of the seven
    distributions over factor columns with Python numbers for bounds, or
    its program needs more than `task_eval.MAX_PRED_DEPTH` results at
    once."""
    words = []

    def emit(d) -> Optional[int]:
        """Appends `d`'s postfix program to `words`; returns the most
        results it holds at once, or None."""
        kind = type(d)
        if kind is distribs.Continuous:
            if (d.key not in state_lib.FACTOR_INDEX
                    or not (_number(d.minval) and _number(d.maxval))):
                return None
            words.extend([task_eval.P_CONTINUOUS,
                          state_lib.FACTOR_INDEX[d.key],
                          task_eval.f32_bits(d.minval),
                          task_eval.f32_bits(d.maxval)])
            return 1
        if kind is distribs.Discrete:
            if d.key not in state_lib.FACTOR_INDEX:
                return None
            cands = np.asarray(d.candidates, np.float32).reshape(-1)
            words.extend([task_eval.P_DISCRETE,
                          state_lib.FACTOR_INDEX[d.key], cands.size])
            words.extend(int(w) for w in cands.view(np.int32))
            return 1
        if kind in (distribs.Product, distribs.Intersection,
                    distribs.Mixture, distribs.Selection):
            parts = ([d.base, d.filtering] if kind is distribs.Selection
                     else d.components)
            if not 1 <= len(parts) <= task_eval.MAX_PRED_DEPTH:
                return None
            depth = 0
            for i, part in enumerate(parts):
                held = emit(part)
                if held is None:
                    return None
                depth = max(depth, i + held)
            words.extend([task_eval.P_ANY if kind is distribs.Mixture
                          else task_eval.P_ALL, len(parts)])
            return depth
        if kind is distribs.SetMinus:
            base, hold_out = emit(d.base), emit(d.hold_out)
            if base is None or hold_out is None:
                return None
            words.append(task_eval.P_AND_NOT)
            return max(base, 1 + hold_out)
        return None

    if dist is None:
        words.append(task_eval.P_TRUE)
        depth = 1
    else:
        depth = emit(dist)
    if depth is None or depth > task_eval.MAX_PRED_DEPTH:
        return None
    programs.append(words + [task_eval.P_END])
    return len(programs) - 1


def task_table(task) -> Optional[np.ndarray]:
    """The `ops.task_eval` table of `task` (int32 words), built once from
    its tree, or None where the kernel cannot evaluate it: a node that is
    not exactly a NoReward, FindGoalPosition, Clustering (1 to
    `MAX_CLUSTERS` clusters) or MetaAggregated (at least one subtask;
    "sum", "max" or "min"), a filter or cluster `_predicate` cannot
    compile, a parameter that is not a Python number (a goal or weights
    of other than two float32 values), a tree deeper than the kernel's
    task stack, or a table larger than `MAX_WORDS`. Predicate references
    are written as program indices and resolved to word offsets at the
    end."""
    nodes, programs = [], []
    pred = object()  # marks a node word that names a predicate program

    def walk(t) -> Optional[int]:
        """Appends `t`'s nodes in postfix order; returns the entries of the
        task stack its evaluation holds at once, or None."""
        kind = type(t)
        if kind is NoReward:
            nodes.append([task_eval.T_NO_REWARD])
            return 1
        if kind is FindGoalPosition:
            scalars = (t._terminate_distance, t._raw_reward_multiplier,
                       t._terminate_bonus)
            p = _predicate(t._filter_distrib, programs)
            if (p is None or t._goal_position.shape != (2,)
                    or t._weights_dimensions.shape != (2,)
                    or not all(map(_number, scalars))):
                return None
            nodes.append([task_eval.T_GOAL, (pred, p)]
                         + [task_eval.f32_bits(v) for v in (
                             *t._goal_position, *t._weights_dimensions,
                             *scalars)]
                         + [int(bool(t._sparse_reward))])
            return 1
        if kind is Clustering:
            scalars = (t._termination_threshold, t._terminate_bonus,
                       t._reward_range)
            ps = [_predicate(d, programs) for d in t._cluster_distribs]
            if (not 1 <= len(ps) <= task_eval.MAX_CLUSTERS
                    or None in ps or not all(map(_number, scalars))):
                return None
            nodes.append([task_eval.T_CLUSTER, len(ps)]
                         + [task_eval.f32_bits(v) for v in scalars]
                         + [int(bool(t._sparse_reward))]
                         + [(pred, p) for p in ps])
            return 1
        if kind is MetaAggregated:
            aggregators = {"sum": task_eval.A_SUM, "max": task_eval.A_MAX,
                           "min": task_eval.A_MIN}
            if (t._aggregator_name not in aggregators or not t._subtasks
                    or not _number(t._terminate_bonus)):
                return None
            depth = 0
            for i, sub in enumerate(t._subtasks):
                held = walk(sub)
                if held is None:
                    return None
                depth = max(depth, i + held)
            nodes.append([task_eval.T_META, len(t._subtasks),
                          aggregators[t._aggregator_name],
                          {"all": task_eval.C_ALL,
                           "any": task_eval.C_ANY}[t._criterion_name],
                          int(bool(t._terminate_bonus)),
                          task_eval.f32_bits(t._terminate_bonus)])
            return depth
        return None

    depth = walk(task)
    if depth is None or depth > task_eval.MAX_TASK_DEPTH:
        return None
    start = task_eval.HEADER + sum(len(n) for n in nodes)
    offsets = np.cumsum([start] + [len(p) for p in programs]).tolist()
    words = [len(nodes), depth]
    for node in nodes:
        words.extend(offsets[w[1]] if isinstance(w, tuple) else w
                     for w in node)
    for program in programs:
        words.extend(program)
    if len(words) > task_eval.MAX_WORDS:
        return None
    return np.asarray(words, np.int32)


class Evaluator:
    """A task's reward f32[B], success bool[B] and validity bool[B] at one
    of a step's call sites (`site`: the environment names them
    "transition", "fresh", "render" and "observe").

    `evaluate` computes the outputs `want` asks for (a union of REWARD,
    SUCCESS and VALID) and gives None for the others. Where the task has
    a table (`task_table`, built here once) and `task_eval.takes` the
    factors, that is one launch of the kernel for all three; else the
    task's own `reward`, `success` and `task_valid`, called in that order
    for what `want` asks. Each call counts its route ("kernel" or
    "plain") by the task's class into the census of a graph being
    captured (`utils.profiling.task_route`)."""

    def __init__(self, task):
        self.task = task
        self.table = task_table(task)
        self._name = type(task).__name__

    def evaluate(self, factors, num_sprites, want: int, site: str):
        if self.table is not None and task_eval.takes(factors):
            profiling.task_route(self._name, "kernel")
            return task_eval.task_eval(self.table, factors, num_sprites,
                                       want, site)
        profiling.task_route(self._name, "plain")
        t = self.task
        return (t.reward(factors, num_sprites) if want & REWARD else None,
                t.success(factors, num_sprites) if want & SUCCESS else None,
                task_valid(t, factors, num_sprites) if want & VALID
                else None)
