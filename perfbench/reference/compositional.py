"""What the compositional example needs of the plain reference beyond
`engine`: NumPy and Pillow, written from upstream Spriteworld v1.0.2's
description (shapes.py, factor_distributions.py, sprite_generators.py,
tasks.py, renderers/pil_renderer.py), importing nothing of the program.

- Shapes: the pentagon, `star_4` and `spoke_4` of upstream's shapes.py
  (unit area, counter-clockwise), beside `engine`'s three; a sprite's
  `shape` factor holds the shape's id.
- Factors: `IntContinuous`, a uniform draw cast to an integer dtype
  (truncation toward zero), held as float32 in the state.
- Counts: `RandGenerate`, `RandInt(lo, hi)` sprites a lane in [lo, hi),
  drawn from the generator's count key as `jax.random.randint` draws;
  `engine.Chain` packs the live ones to the front.
- Tasks: `Clustering` (sklearn's `davies_bouldin_score`), a goal task
  with `weights_dimensions`, and `MetaAggregated` whose NaN-ignoring sum
  adds the subtasks in their order.
- `Env`: `engine.Env` over these shapes, rendering colours as given (no
  HSV map).

Departures from upstream, all from the float32 state: positions, distances
and rewards are float32, as `engine` notes; sklearn computes the
Davies-Bouldin index in float64 and measures a distance through
`|x|^2 - 2 x.y + |y|^2`, here it is float32 with each distance from the
difference, sqrt(dx*dx + dy*dy) (each product rounded, the root correctly
rounded). Every sum of more than two float32 terms is a left fold in slot
(or cluster, or subtask) order: a centroid is the fold of its members'
positions in slot order over their count, a spread the fold of their
distances over the count, the index the fold of the clusters' scores over
their number. Where sklearn raises, fewer than two clusters read NaN.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw

from perfbench.reference import engine
from perfbench.reference.threefry import Rng

F32 = np.float32
ATOL = 1e-8  # np.allclose's, in sklearn's two zero checks

SHAPE_IDS = dict(engine.SHAPE_IDS, pentagon=3, star_4=7, spoke_4=10)


def _circle(angles: np.ndarray, radius: float = 1.0) -> np.ndarray:
    return radius * np.stack([np.cos(angles), np.sin(angles)], -1)


def _star(num_sides: int, theta_0: float, point_height: float = 1.0):
    """Points of height `point_height` between the unit circle's
    vertices: inner at i * t + theta_0, tips at (i + 1/2) * t + theta_0,
    t = 2 pi / n; area (1 + h) n sin(t / 2)."""
    theta = 2.0 * np.pi / num_sides
    i = np.arange(num_sides)
    verts = np.empty((2 * num_sides, 2))
    verts[0::2] = _circle(theta_0 + i * theta)
    verts[1::2] = _circle(theta_0 + (i + 0.5) * theta, 1.0 + point_height)
    area = (1.0 + point_height) * num_sides * np.sin(theta / 2.0)
    return (verts / np.sqrt(area)).astype(F32)


def _spokes(num_sides: int, theta_0: float, spoke_height: float = 1.0):
    """Square-tipped spokes: for each unit-circle vertex v_i, v_i + s_(i -
    1/2), v_i, v_i + s_(i + 1/2), s_a of length `spoke_height` at angle a *
    t + theta_0; area n sin(t / 2) (2 + cos(t / 2))."""
    theta = 2.0 * np.pi / num_sides
    i = np.arange(num_sides)
    base = _circle(theta_0 + i * theta)
    verts = np.empty((3 * num_sides, 2))
    verts[0::3] = base + _circle(theta_0 + (i - 0.5) * theta, spoke_height)
    verts[1::3] = base
    verts[2::3] = base + _circle(theta_0 + (i + 0.5) * theta, spoke_height)
    area = num_sides * np.sin(theta / 2.0) * (2.0 + np.cos(theta / 2.0))
    return (verts / np.sqrt(area)).astype(F32)


VERTICES = dict(engine.VERTICES)
VERTICES[SHAPE_IDS["pentagon"]] = engine._polygon(5, np.pi / 2)
VERTICES[SHAPE_IDS["star_4"]] = _star(4, np.pi / 4)
VERTICES[SHAPE_IDS["spoke_4"]] = _spokes(4, np.pi / 4)


def shape_ids(names: Sequence[str]) -> List[int]:
    return [SHAPE_IDS[n] for n in names]


# ---------------------------------------------------------------------- #
# Factors and scenes.

class IntContinuous(engine.Continuous):
    """Continuous(key, lo, hi, dtype=int32 or uint8): a uniform draw on
    [lo, hi), truncated toward zero (every value fits the dtype)."""

    def sample(self, rng: Rng, keys):
        return {self.key: np.trunc(super().sample(rng, keys)[self.key])}


class RandGenerate(engine.Generate):
    """RandInt(lo, hi) sprites a lane, at most hi - 1: the generator's key
    splits into the count's key and the sprites'; the slots past the
    count hold the default row."""

    def __init__(self, dist, lo: int, hi: int):
        super().__init__(dist, hi - 1)
        self.lo, self.hi = int(lo), int(hi)

    def sample(self, rng: Rng, keys):
        f, _ = super().sample(rng, keys)
        num = rng.randint(rng.child(keys, 0), self.lo, self.hi)
        f[np.arange(self.num) >= num[:, None]] = engine.DEFAULT_ROW
        return f, num


# ---------------------------------------------------------------------- #
# Tasks.

def fold(terms):
    """((t_0 + t_1) + t_2) + ...: the terms summed in their order."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _distance(a: np.ndarray, b: np.ndarray) -> np.float32:
    d = (a - b).astype(F32)
    sq = d * d
    return F32(np.sqrt(np.float64(sq[0] + sq[1])))


def davies_bouldin(points: np.ndarray, labels: np.ndarray) -> np.float32:
    """sklearn's davies_bouldin_score of points f32[n, 2] (slot order)
    under labels int[n], in float32 (see the module's docstring)."""
    clusters = np.unique(labels)
    if len(clusters) < 2:
        return F32(np.nan)
    centroids, spreads = [], []
    for c in clusters:
        members = list(points[labels == c])
        n = F32(len(members))
        centroid = fold(members) / n
        centroids.append(centroid)
        spreads.append(fold([_distance(p, centroid) for p in members]) / n)
    k = len(clusters)
    dist = np.zeros((k, k), F32)
    for i in range(k):
        for j in range(k):
            dist[i, j] = _distance(centroids[i], centroids[j])
    if all(s <= ATOL for s in spreads) or (dist <= ATOL).all():
        return F32(0)
    dist[dist == 0] = np.inf
    scores = [max((spreads[i] + spreads[j]) / dist[i, j] for j in range(k))
              for i in range(k)]
    return F32(fold(scores) / F32(k))


class Clustering:
    """Upstream's Clustering: each live sprite labelled by the first
    cluster distribution that contains it (sprites in none left out), the
    metric 1 / Davies-Bouldin of the labelled sprites' positions, the
    reward (metric - threshold) * reward_range / 2, success where the
    metric reaches the threshold."""

    def __init__(self, cluster_distribs, termination_threshold=2.5,
                 terminate_bonus=0.0, sparse_reward=False, reward_range=10.0):
        self.clusters = list(cluster_distribs)
        self.threshold = F32(termination_threshold)
        self.bonus = F32(terminate_bonus)
        self.sparse = sparse_reward
        self.range = F32(reward_range)

    def labels(self, factors, num) -> np.ndarray:
        """int[L, K]: each live sprite's first containing cluster, else
        -1."""
        spec = engine._spec(factors)
        out = np.full(factors.shape[:2], -1)
        for c in reversed(range(len(self.clusters))):
            out = np.where(self.clusters[c].contains(spec), c, out)
        return np.where(np.arange(factors.shape[1]) < num[:, None], out, -1)

    def metric(self, factors, num) -> np.ndarray:
        labels = self.labels(factors, num)
        out = np.empty(len(num), F32)
        with np.errstate(divide="ignore"):
            for lane, lab in enumerate(labels):
                keep = lab >= 0
                out[lane] = F32(1) / davies_bouldin(
                    factors[lane, keep, 0:2], lab[keep])
        return out

    def reward(self, factors, num):
        metric = self.metric(factors, num)
        dense = (metric - self.threshold) * self.range / F32(2)
        ok = metric >= self.threshold
        return np.where(ok, self.bonus + dense,
                        F32(0) if self.sparse else dense).astype(F32)

    def success(self, factors, num):
        return self.metric(factors, num) >= self.threshold


class FindGoalPosition(engine.FindGoalPosition):
    """The goal task with `weights_dimensions` (w_x, w_y): the distance is
    sqrt(w_x dx^2 + w_y dy^2); the reward a fold of the filtered sprites'
    rewards in slot order."""

    def __init__(self, filter_distrib, weights_dimensions=(1, 1), **kwargs):
        super().__init__(filter_distrib, **kwargs)
        self.weights = np.array(weights_dimensions, F32)

    def _per_sprite(self, factors, num):
        d = factors[..., 0:2] - self.goal
        sq = self.weights * (d * d)
        dist = np.sqrt((sq[..., 0] + sq[..., 1]).astype(np.float64))
        rewards = self.multiplier * (self.distance - dist.astype(F32))
        alive = np.arange(factors.shape[1]) < num[:, None]
        return rewards, alive & self.filter.contains(engine._spec(factors))

    def reward(self, factors, num):
        rewards, mask = self._per_sprite(factors, num)
        dense = fold(list(np.where(mask, rewards, F32(0)).T))
        return np.where(mask.any(-1), dense, F32(np.nan)).astype(F32)


class MetaAggregated:
    """Subtask rewards summed in the subtasks' order ignoring NaN, plus
    terminate_bonus where every subtask succeeds; success where all do."""

    def __init__(self, subtasks, terminate_bonus=0.0):
        self.subtasks = list(subtasks)
        self.bonus = F32(terminate_bonus)

    def reward(self, factors, num):
        rewards = [t.reward(factors, num) for t in self.subtasks]
        total = fold([np.where(np.isnan(r), F32(0), r) for r in rewards])
        return (total + self.bonus * self.success(factors, num)).astype(F32)

    def success(self, factors, num):
        return np.all([t.success(factors, num) for t in self.subtasks], 0)


# ---------------------------------------------------------------------- #
# Geometry, rendering and the environment.

def world_vertices(row: np.ndarray) -> np.ndarray:
    """`engine.world_vertices` over this module's shapes."""
    base = VERTICES[int(row[engine.COLUMN["shape"]])] \
        * row[engine.COLUMN["scale"]]
    rad = F32(row[engine.COLUMN["angle"]] * F32(np.pi / 180.0))
    c, s = F32(np.cos(np.float64(rad))), F32(np.sin(np.float64(rad)))
    vx, vy = base[:, 0], base[:, 1]
    return np.stack([c * vx - s * vy, s * vx + c * vy], -1) + row[0:2]


def render(factors: np.ndarray, num: int, image_size, anti_aliasing: int):
    """u8[H, W, 3] of one scene: upstream's PILRenderer with no colour
    map, each sprite filled with its (c0, c1, c2) as given."""
    h, w = image_size
    hc, wc = h * anti_aliasing, w * anti_aliasing
    im = Image.new("RGB", (wc, hc), (0, 0, 0))
    draw = ImageDraw.Draw(im)
    canvas = np.array([wc, hc], F32)
    for i in range(num):
        verts = np.trunc(world_vertices(factors[i]) * canvas)
        draw.polygon([(int(x), int(y)) for x, y in verts],
                     fill=tuple(int(c) for c in factors[i, 5:8]))
    if anti_aliasing != 1:
        im = im.resize((w, h), resample=Image.LANCZOS)
    return np.asarray(im)[::-1]


class Env(engine.Env):
    """`engine.Env` with this module's shapes and colours as given."""

    def step(self, state: engine.State, actions: np.ndarray):
        lanes = len(state.num)
        new = state.copy()
        step_type = np.full(lanes, engine.MID, np.int32)
        reward = np.zeros(lanes, F32)
        reset = np.flatnonzero(state.reset_next)
        go = np.flatnonzero(~state.reset_next)
        if len(reset):
            new.put(reset, self.fresh(state.key[reset]))
            step_type[reset] = engine.FIRST
        if len(go):
            s = state.take(go)
            f = s.factors.copy()
            actions = np.asarray(actions, F32)[go]
            motion = (actions[:, 2:] - F32(0.5)) * self.move_scale
            for lane in range(len(go)):
                hit = [i for i in range(s.num[lane])
                       if engine.contains_point(world_vertices(f[lane, i]),
                                                actions[lane, :2])]
                if hit:
                    i = hit[-1]  # the foreground-most sprite moves
                    f[lane, i, 0:2] = np.clip(f[lane, i, 0:2]
                                              + motion[lane], 0, 1)
            f[..., 0:2] = np.clip(f[..., 0:2] + f[..., 8:10], 0, 1)
            f = self.round(f)
            r = self.round(self.task.reward(f, s.num))
            success = self.task.success(f, s.num)
            pos = f[..., 0:2]
            alive = np.arange(f.shape[1]) < s.num[:, None]
            oof = (((pos < 0) | (pos > 1)).any(-1) & alive).any(-1)
            count = s.step_count + 1
            end = success | oof | (count >= self.max_episode_length)
            new.put(go, engine.State(f, s.num, count, end,
                                     self.rng.child(s.key, 0)))
            step_type[go] = np.where(end, engine.LAST, engine.MID)
            reward[go] = r
        return new, step_type, reward

    def observe(self, state: engine.State, name: str = "image"):
        if name != "image":
            raise KeyError(f"the reference renders no observation {name!r}")
        return np.stack([render(state.factors[i], int(state.num[i]),
                                self.image_size, self.anti_aliasing)
                         for i in range(len(state.num))])
