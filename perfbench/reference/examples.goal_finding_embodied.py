"""The reference of Spriteworld's embodied goal-finding example.

Upstream: google-deepmind/spriteworld v1.0.2,
spriteworld/configs/examples/goal_finding_embodied.py. RandInt(1, 4)
targets (hue c0 in [0, 0.4)) and RandInt(1, 4) distractors (c0 in [0.5,
0.9)), each at x, y in [0.1, 0.9), a square, triangle or circle at scale
0.13, c1 in [0.3, 1.0), c2 in [0.9, 1.0), chained and shuffled; then the
agent's body, a magenta circle (c0 1, c1 0, c2 1) at scale 0.07 and x, y
in [0.1, 0.9), chained after the shuffle, so it is the last live sprite
of up to 7 slots. The task is FindGoalPosition over the target hue (goal
(0.5, 0.5), distance 0.075, multiplier 50); an episode ends when every
target is within it or after 50 steps. A 64x64 HSV image at
anti_aliasing 5.

The action space is upstream's `Embodied(step_size=0.05)`
(action_spaces.py): an action is [carry in {0, 1}, direction in {0..3}],
the direction's step being up (0, 0.05), left (-0.05, 0), down (0, -0.05)
or right (0.05, 0). The body is the last live sprite. With carry set, the
topmost live non-body sprite that contains the body's centre, found from
the positions before the move, moves by the step first; then the body
moves by it. Each move is clipped to the frame; then every sprite's
velocity is integrated and clipped. The motion cost is 0.

Departures from upstream: the state is float32, as `engine` notes, so a
move adds the float32 step to float32 positions. Upstream draws the
counts from NumPy's global generator and its agents pick actions
themselves; here the counts come from the generator's key as
`jax.random.randint` draws them, and the random policy's action from the
lane's action key, split in two: carry `randint` [0, 2) from the first,
direction `randint` [0, 4) from the second. The runner loop's `simulate`
holds every action in a float32 [L, 4] buffer, so `random_actions` gives
[carry, direction, 0, 0] in float32 (which holds small integers exactly)
and `step` reads the first two columns as integers.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import compositional as c
from perfbench.reference import engine as e

F32 = np.float32
IMAGE_SIZE = (64, 64)
ANTI_ALIASING = 5
STEP_SIZE = F32(0.05)
# Upstream's _action_to_motion: up, left, down, right.
MOTIONS = np.array([[0, STEP_SIZE], [-STEP_SIZE, 0], [0, -STEP_SIZE],
                    [STEP_SIZE, 0]], F32)


class EmbodiedEnv(e.Env):
    """`engine.Env` with Embodied's motion in place of SelectMove's."""

    def random_actions(self, lane_keys) -> np.ndarray:
        """f32[L, 4]: [carry, direction, 0, 0] a lane key, the key split
        in two, carry from the first half and direction from the second."""
        halves = self.rng.split(lane_keys, 2)
        out = np.zeros((len(lane_keys), 4), F32)
        out[:, 0] = self.rng.randint(halves[:, 0], 0, 2)
        out[:, 1] = self.rng.randint(halves[:, 1], 0, 4)
        return out

    def move(self, f: np.ndarray, num: np.ndarray, actions: np.ndarray):
        """Embodied's step on factors f32[L, K, 10] in place, lanes of
        `num` live sprites, actions [carry, direction, ...]."""
        carry = actions[:, 0].astype(np.int64)
        motion = MOTIONS[actions[:, 1].astype(np.int64)]
        for lane in range(len(num)):
            if num[lane] == 0:
                continue
            body = num[lane] - 1
            centre = f[lane, body, 0:2].copy()
            hit = [i for i in range(body)
                   if e.contains_point(e.world_vertices(f[lane, i]),
                                       centre)]
            moved = ([hit[-1]] if carry[lane] > 0 and hit else []) + [body]
            for i in moved:  # the carried sprite first, then the body
                f[lane, i, 0:2] = np.clip(f[lane, i, 0:2] + motion[lane],
                                          0, 1)

    def step(self, state: e.State, actions: np.ndarray):
        lanes = len(state.num)
        new = state.copy()
        step_type = np.full(lanes, e.MID, np.int32)
        reward = np.zeros(lanes, F32)
        reset = np.flatnonzero(state.reset_next)
        go = np.flatnonzero(~state.reset_next)
        if len(reset):
            new.put(reset, self.fresh(state.key[reset]))
            step_type[reset] = e.FIRST
        if len(go):
            s = state.take(go)
            f = s.factors.copy()
            self.move(f, s.num, np.asarray(actions, F32)[go])
            f[..., 0:2] = np.clip(f[..., 0:2] + f[..., 8:10], 0, 1)
            f = self.round(f)
            r = self.round(self.task.reward(f, s.num))
            success = self.task.success(f, s.num)
            pos = f[..., 0:2]
            alive = np.arange(f.shape[1]) < s.num[:, None]
            oof = (((pos < 0) | (pos > 1)).any(-1) & alive).any(-1)
            count = s.step_count + 1
            end = success | oof | (count >= self.max_episode_length)
            new.put(go, e.State(f, s.num, count, end,
                                self.rng.child(s.key, 0)))
            step_type[go] = np.where(end, e.LAST, e.MID)
            reward[go] = r
        return new, step_type, reward


def build(precision: str = "float32", image_size=IMAGE_SIZE,
          anti_aliasing: int = ANTI_ALIASING) -> EmbodiedEnv:
    """The example's environment; `image_size` and `anti_aliasing` change
    the frame only (the tests render it small)."""
    shared = e.Product([
        e.Continuous("x", 0.1, 0.9),
        e.Continuous("y", 0.1, 0.9),
        e.Discrete("shape", ["square", "triangle", "circle"]),
        e.Discrete("scale", [0.13]),
        e.Continuous("c1", 0.3, 1.0),
        e.Continuous("c2", 0.9, 1.0),
    ])
    target_hue = e.Continuous("c0", 0.0, 0.4)
    distractor_hue = e.Continuous("c0", 0.5, 0.9)
    objects = e.Shuffle(e.Chain(
        c.RandGenerate(e.Product([target_hue, shared]), 1, 4),
        c.RandGenerate(e.Product([distractor_hue, shared]), 1, 4)))
    body = e.Generate(e.Product([
        e.Continuous("x", 0.1, 0.9),
        e.Continuous("y", 0.1, 0.9),
        e.Discrete("shape", ["circle"]),
        e.Discrete("scale", [0.07]),
        e.Discrete("c0", [1.0]),
        e.Discrete("c1", [0.0]),
        e.Discrete("c2", [1.0]),
    ]), 1)
    task = c.FindGoalPosition(target_hue, terminate_distance=0.075)
    return EmbodiedEnv(e.Chain(objects, body), task, max_episode_length=50,
                       image_size=image_size, anti_aliasing=anti_aliasing,
                       precision=precision)
