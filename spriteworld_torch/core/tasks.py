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
CPU and the card.

Tracing: each subtask of a MetaAggregated runs in its own span,
`env.task.<Class>#<i>` (i its place among the subtasks), and each task
method counts its calls into the census of a graph being captured
(`utils.profiling.evaluation`).

Goal distance: each product of ``sum(w * (pos - goal)**2)`` is rounded once
before the sum, as the TPU computes it (Mosaic and XLA on the TPU do not
contract a multiply and an add into one FMA; XLA on the CPU does, so the
JAX package on the CPU can differ from the port by an ulp off the grid).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import clustering as clustering_ops
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
        dense = torch.where(mask, rewards, zero).sum(-1)
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
