"""The plain reference of a Spriteworld environment: NumPy and Pillow.

The same semantics as upstream Spriteworld (google-deepmind/spriteworld
v1.0.2) as the JAX package states them, written again from scratch and
importing nothing of the program: the factor distributions, the scene
generators, the SelectMove transition, the tasks, the per-lane auto-reset,
and the PILRenderer (ImageDraw.polygon on an anti_aliasing-times canvas,
resize with Lanczos, vertical flip). State is float32, as the
configurations state it; every key comes from `threefry.Rng`, split as
`jax.random` splits it in the JAX package.

`Precision` rounds what the state holds: float32 is the configuration's
own; the control of `perfbench/check.py` rounds every factor to bfloat16.

The reference draws only what its outputs need: a scene only for the lanes
that reset, a rejection node's rounds only until its proposal is accepted,
one generator of a `SampleGenerator`, so `Rng.blocks` counts the least
threefry work of what it computed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image, ImageDraw

from perfbench.reference.threefry import Rng

F32 = np.float32
FACTOR_NAMES = ("x", "y", "shape", "angle", "scale", "c0", "c1", "c2",
                "x_vel", "y_vel")
COLUMN = {n: i for i, n in enumerate(FACTOR_NAMES)}
# Upstream Sprite's defaults: x=y=0.5, shape square, angle 0, scale 0.1.
DEFAULT_ROW = np.array([0.5, 0.5, 2, 0, 0.1, 0, 0, 0, 0, 0], F32)
SHAPE_IDS = {"triangle": 1, "square": 2, "circle": 6}
FIRST, MID, LAST = 0, 1, 2


# ---------------------------------------------------------------------- #
# Shapes (upstream shapes.py): unit-area polygons, counter-clockwise.

def _polygon(num_sides: int, theta_0: float) -> np.ndarray:
    theta = 2.0 * np.pi / num_sides
    angles = theta_0 + theta * np.arange(num_sides)
    area = num_sides * np.sin(theta / 2.0) * np.cos(theta / 2.0)
    pts = np.stack([np.cos(angles), np.sin(angles)], -1)
    return (pts / np.sqrt(area)).astype(F32)


VERTICES = {
    SHAPE_IDS["triangle"]: _polygon(3, np.pi / 2),
    SHAPE_IDS["square"]: _polygon(4, np.pi / 4),
    SHAPE_IDS["circle"]: _polygon(30, 0.0),
}


class Precision:
    """What the state's float32 factors are rounded to."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, F32)
        if self.name == "float32":
            return x
        b = x.view(np.uint32).astype(np.uint64)
        b = (b + ((b >> 16) & 1) + 0x7FFF) & 0xFFFF0000
        return b.astype(np.uint32).view(F32)


# ---------------------------------------------------------------------- #
# Factor distributions: sample(rng, keys [L, 2]) -> {name: f32[L]}.

class Continuous:
    def __init__(self, key: str, lo: float, hi: float):
        self.key, self.lo, self.hi = key, lo, hi
        self.keys = frozenset([key])

    def sample(self, rng: Rng, keys):
        return {self.key: rng.uniform(keys, 1, self.lo, self.hi)[:, 0]}

    def contains(self, spec):
        v = spec[self.key]
        return (v >= F32(self.lo)) & (v < F32(self.hi))


class Discrete:
    def __init__(self, key: str, candidates: Sequence):
        self.key = key
        self.candidates = np.array(
            [SHAPE_IDS[c] if isinstance(c, str) else c for c in candidates],
            F32)
        self.keys = frozenset([key])

    def sample(self, rng: Rng, keys):
        idx = rng.randint(keys, 0, len(self.candidates))
        return {self.key: self.candidates[idx]}

    def contains(self, spec):
        return (spec[self.key][..., None] == self.candidates).any(-1)


class Product:
    def __init__(self, components):
        self.components = list(components)
        self.keys = frozenset().union(*[c.keys for c in self.components])

    def sample(self, rng: Rng, keys):
        out = {}
        for i, c in enumerate(self.components):
            out.update(c.sample(rng, rng.child(keys, i)))
        return out

    def contains(self, spec):
        return np.all([c.contains(spec) for c in self.components], 0)


class SetMinus:
    """base minus hold_out by rejection: proposal r from sub_r of the chain
    sub_r = T(s_r, 1), s_{r+1} = T(s_r, 0); the first proposal outside
    hold_out is taken (upstream raises after 100,000 tries)."""

    MAX_TRIES = 100_000

    def __init__(self, base, hold_out):
        self.base, self.hold_out = base, hold_out
        self.keys = base.keys

    def sample(self, rng: Rng, keys):
        state = keys.copy()
        out = None
        pending = np.arange(len(keys))
        for _ in range(self.MAX_TRIES):
            if not len(pending):
                return out
            s = state[pending]
            spec = self.base.sample(rng, rng.child(s, 1))
            state[pending] = rng.child(s, 0)
            if out is None:
                out = {k: np.zeros(len(keys), F32) for k in spec}
            ok = ~self.hold_out.contains(spec)
            for k, v in spec.items():
                out[k][pending[ok]] = v[ok]
            pending = pending[~ok]
        raise ValueError("rejection sampling ran out of tries")

    def contains(self, spec):
        return self.base.contains(spec) & ~self.hold_out.contains(spec)


# ---------------------------------------------------------------------- #
# Scene generators: sample(rng, keys [L, 2]) -> (f32[L, K, 10], i32[L]).

def _rows(lanes: int, k: int) -> np.ndarray:
    return np.tile(DEFAULT_ROW, (lanes, k, 1))


class Generate:
    """`num` sprites (a fixed count) from a factor distribution."""

    def __init__(self, dist, num: int):
        self.dist, self.num = dist, int(num)
        self.max_sprites = self.num

    def sample(self, rng: Rng, keys):
        lanes = len(keys)
        sprite_keys = rng.child(keys, 1)  # split(key, 2)[1]: the sprites'
        f = _rows(lanes, self.num)
        for j in range(self.num):
            spec = self.dist.sample(rng, rng.child(sprite_keys, j))
            for name, v in spec.items():
                f[:, j, COLUMN[name]] = v
        return f, np.full(lanes, self.num, np.int32)


class Chain:
    def __init__(self, *gens):
        self.gens = gens
        self.max_sprites = sum(g.max_sprites for g in gens)

    def sample(self, rng: Rng, keys):
        parts, live = [], []
        for i, g in enumerate(self.gens):
            f, n = g.sample(rng, rng.child(keys, i))
            parts.append(f)
            live.append(np.arange(g.max_sprites) < n[:, None])
        f, live = np.concatenate(parts, 1), np.concatenate(live, 1)
        order = np.argsort(~live, axis=1, kind="stable")
        f = np.take_along_axis(f, order[..., None], 1)
        num = live.sum(1).astype(np.int32)
        f[np.arange(f.shape[1]) >= num[:, None]] = DEFAULT_ROW
        return f, num


class SampleGenerator:
    """One of `gens` a lane, uniformly; scenes padded to the largest."""

    def __init__(self, gens):
        self.gens = list(gens)
        self.max_sprites = max(g.max_sprites for g in self.gens)

    def sample(self, rng: Rng, keys):
        lanes = len(keys)
        idx = rng.randint(rng.child(keys, 0), 0, len(self.gens))
        scene_keys = rng.child(keys, 1)
        f = _rows(lanes, self.max_sprites)
        num = np.zeros(lanes, np.int32)
        for i, g in enumerate(self.gens):
            sel = np.flatnonzero(idx == i)
            if len(sel):
                fi, ni = g.sample(rng, scene_keys[sel])
                f[sel, :g.max_sprites] = fi
                num[sel] = ni
        return f, num


class Shuffle:
    """A uniform z-order of the live sprites."""

    def __init__(self, gen):
        self.gen = gen
        self.max_sprites = gen.max_sprites

    def sample(self, rng: Rng, keys):
        f, num = self.gen.sample(rng, rng.child(keys, 0))
        k = self.max_sprites
        r = rng.uniform(rng.child(keys, 1), k)
        r = np.where(np.arange(k) < num[:, None], r, np.inf)
        order = np.argsort(r, axis=1, kind="stable")
        return np.take_along_axis(f, order[..., None], 1), num


# ---------------------------------------------------------------------- #
# Tasks: reward(factors, num) -> f32[L], success -> bool[L].

def _spec(factors):
    return {n: factors[..., i] for i, n in enumerate(FACTOR_NAMES)}


class FindGoalPosition:
    def __init__(self, filter_distrib, goal_position=(0.5, 0.5),
                 terminate_distance=0.05, raw_reward_multiplier=50.0):
        self.filter = filter_distrib
        self.goal = np.array(goal_position, F32)
        self.distance = F32(terminate_distance)
        self.multiplier = F32(raw_reward_multiplier)

    def _per_sprite(self, factors, num):
        d = factors[..., 0:2] - self.goal
        sq = d * d
        dist = np.sqrt((sq[..., 0] + sq[..., 1]).astype(np.float64))
        rewards = self.multiplier * (self.distance - dist.astype(F32))
        alive = np.arange(factors.shape[1]) < num[:, None]
        return rewards, alive & self.filter.contains(_spec(factors))

    def reward(self, factors, num):
        rewards, mask = self._per_sprite(factors, num)
        dense = np.where(mask, rewards, F32(0)).sum(-1, dtype=F32)
        return np.where(mask.any(-1), dense, F32(np.nan)).astype(F32)

    def success(self, factors, num):
        rewards, mask = self._per_sprite(factors, num)
        return np.where(mask, rewards >= 0, True).all(-1)


class MetaAggregated:
    """Subtask rewards summed ignoring NaN; success where all succeed."""

    def __init__(self, subtasks: List[FindGoalPosition]):
        self.subtasks = list(subtasks)

    def reward(self, factors, num):
        r = np.stack([t.reward(factors, num) for t in self.subtasks])
        return np.nansum(r, 0, dtype=F32).astype(F32)

    def success(self, factors, num):
        return np.all([t.success(factors, num) for t in self.subtasks], 0)


# ---------------------------------------------------------------------- #
# Geometry and rendering.

def world_vertices(row: np.ndarray) -> np.ndarray:
    """f32[V, 2] of one sprite's factor row: the shape scaled, rotated
    counter-clockwise by its angle, then moved to its position."""
    base = VERTICES[int(row[COLUMN["shape"]])] * row[COLUMN["scale"]]
    rad = F32(row[COLUMN["angle"]] * F32(np.pi / 180.0))
    c, s = F32(np.cos(np.float64(rad))), F32(np.sin(np.float64(rad)))
    vx, vy = base[:, 0], base[:, 1]
    return np.stack([c * vx - s * vy, s * vx + c * vy], -1) + row[0:2]


def contains_point(verts: np.ndarray, point: np.ndarray) -> bool:
    """Even-odd crossing test of one point in a closed polygon."""
    x1, y1 = verts[:, 0], verts[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    px, py = point[0], point[1]
    straddles = (y1 > py) != (y2 > py)
    dy = y2 - y1
    t = (py - y1) / np.where(dy == 0, F32(1), dy)
    x_cross = x1 + t * (x2 - x1)
    return bool((straddles & (px < x_cross)).sum() % 2)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """u8[..., 3]: upstream's (255 * colorsys.hsv_to_rgb(h, s, v)) cast to
    uint8, in float32."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * F32(6))
    f = h * F32(6) - i
    i = i.astype(np.int64) % 6
    p = v * (F32(1) - s)
    q = v * (F32(1) - s * f)
    t = v * (F32(1) - s * (F32(1) - f))
    table = np.stack([np.stack(c, -1) for c in (
        (v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))], -1)
    rgb = np.take_along_axis(table, i[..., None, None], -2)[..., 0, :]
    return np.clip(F32(255) * rgb, 0, 255).astype(np.uint8)


def render(factors: np.ndarray, num: int, image_size, anti_aliasing: int):
    """u8[H, W, 3] of one scene: upstream PILRenderer with HSV colors."""
    h, w = image_size
    hc, wc = h * anti_aliasing, w * anti_aliasing
    im = Image.new("RGB", (wc, hc), (0, 0, 0))
    draw = ImageDraw.Draw(im)
    colors = hsv_to_rgb(factors[:, 5:8])
    canvas = np.array([wc, hc], F32)
    for i in range(num):
        verts = np.trunc(world_vertices(factors[i]) * canvas)
        draw.polygon([(int(x), int(y)) for x, y in verts],
                     fill=tuple(int(c) for c in colors[i]))
    if anti_aliasing != 1:
        im = im.resize((w, h), resample=Image.LANCZOS)
    return np.asarray(im)[::-1]


# ---------------------------------------------------------------------- #
# The environment.

@dataclasses.dataclass
class State:
    """Lanes' state: factors f32[L, K, 10], num i32[L], step_count i32[L],
    reset_next bool[L], key uint32[L, 2]."""

    factors: np.ndarray
    num: np.ndarray
    step_count: np.ndarray
    reset_next: np.ndarray
    key: np.ndarray

    FIELDS = ("factors", "num", "step_count", "reset_next", "key")

    def take(self, sel) -> "State":
        return State(*(getattr(self, n)[sel] for n in self.FIELDS))

    def put(self, sel, other: "State"):
        for n in self.FIELDS:
            getattr(self, n)[sel] = getattr(other, n)

    def copy(self) -> "State":
        return State(*(getattr(self, n).copy() for n in self.FIELDS))


class Env:
    """One configuration's environment over lanes, as upstream's
    Environment stepped in lockstep with per-lane auto-reset (a lane whose
    last step was LAST takes a fresh scene and emits FIRST)."""

    def __init__(self, scene, task, max_episode_length: int,
                 image_size=(64, 64), anti_aliasing: int = 5,
                 move_scale: float = 0.25, precision: str = "float32"):
        self.scene, self.task = scene, task
        self.max_episode_length = int(max_episode_length)
        self.image_size, self.anti_aliasing = tuple(image_size), anti_aliasing
        self.move_scale = F32(move_scale)
        self.round = Precision(precision)
        self.rng = Rng()

    def fresh(self, keys) -> State:
        """Fresh scenes of lanes whose keys split into the scene's key and
        the next key."""
        f, num = self.scene.sample(self.rng, self.rng.child(keys, 0))
        lanes = len(keys)
        return State(self.round(f), num, np.zeros(lanes, np.int32),
                     np.zeros(lanes, bool), self.rng.child(keys, 1))

    def action_keys(self, action_key, lanes):
        """(next action key, lane action keys uint32[L, 2]) of one runner
        step: the action key splits into the next one and the step's,
        which splits over the global lanes, of which `lanes` are taken."""
        pair = self.rng.split(action_key[None], 2)[0]
        step_key = pair[1]
        lane_keys = self.rng.block(step_key[None], np.asarray(lanes,
                                                              np.uint32))
        return pair[0], lane_keys

    def random_actions(self, lane_keys) -> np.ndarray:
        """f32[L, 4]: one uniform SelectMove action a lane key."""
        return self.rng.uniform(lane_keys, 4)

    def step(self, state: State, actions: np.ndarray):
        """(state, step_type i32[L], reward f32[L]) after one step."""
        lanes = len(state.num)
        new = state.copy()
        step_type = np.full(lanes, MID, np.int32)
        reward = np.zeros(lanes, F32)
        reset = np.flatnonzero(state.reset_next)
        go = np.flatnonzero(~state.reset_next)
        if len(reset):
            new.put(reset, self.fresh(state.key[reset]))
            step_type[reset] = FIRST
        if len(go):
            s = state.take(go)
            f = s.factors.copy()
            actions = np.asarray(actions, F32)[go]
            motion = (actions[:, 2:] - F32(0.5)) * self.move_scale
            for lane in range(len(go)):
                hit = [i for i in range(s.num[lane])
                       if contains_point(world_vertices(f[lane, i]),
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
            new.put(go, State(f, s.num, count, end,
                              self.rng.child(s.key, 0)))
            step_type[go] = np.where(end, LAST, MID)
            reward[go] = r
        return new, step_type, reward

    def observe(self, state: State, name: str = "image"):
        """The observation `name` of each lane: "image", u8[L, H, W, 3]. A
        configuration observed otherwise gives its reference an Env whose
        `observe` knows that name."""
        if name != "image":
            raise KeyError(f"the reference renders no observation {name!r}")
        return np.stack([render(state.factors[i], int(state.num[i]),
                                self.image_size, self.anti_aliasing)
                         for i in range(len(state.num))])

    def reset(self, lane_keys) -> State:
        """Fresh scenes of lane keys uint32[L, 2] (FIRST)."""
        return self.fresh(lane_keys)


def state_dict(state: State) -> Dict[str, np.ndarray]:
    return {n: getattr(state, n) for n in State.FIELDS}
