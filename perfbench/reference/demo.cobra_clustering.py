"""The reference of Spriteworld's interactive demo at its published
defaults: COBRA clustering (train mode) under the demo's overrides.

Upstream: google-deepmind/spriteworld v1.0.2. `run_demo.py:38-45` runs
`configs/cobra/clustering.py` in train mode with HSV task colours, a
256x256 render and anti_aliasing 10; `demo_ui.py:298-334` (`setup_run_ui`)
replaces SelectMove with DragAndDrop(scale=0.5) and the renderers with an
HSV PILRenderer of that size plus Success. The scenes: two hue clusters,
blue (c0 in [0.55, 0.65)) and green (c0 in [0.27, 0.37)), of 2 sprites
each, x, y in [0.1, 0.9), a square, triangle or circle at scale 0.13, c1
in [0.3, 1.0), c2 in [0.9, 1.0), chained and shuffled into 4 slots. The
task is upstream's Clustering over the two hue ranges (Davies-Bouldin,
reward_range 10, threshold 2.5); an episode ends when it succeeds or after
50 steps. DragAndDrop moves the topmost live sprite under the first point
a[:2] by (a[2:] - a[:2]) * 0.5, clipped to the frame.

Cluster membership is read from each sprite's `c0` factor, as upstream's
Clustering reads it (`distrib.contains` of the sprite's factors), not from
the rendered colour. Departures from upstream are those of `engine` and
`compositional`: the state is float32, and the Davies-Bouldin index is
computed in float32 with slot-order folds.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import compositional as c
from perfbench.reference import engine as e

F32 = np.float32
IMAGE_SIZE = (256, 256)
ANTI_ALIASING = 10
MOVE_SCALE = 0.5
CLUSTERS = ((0.55, 0.65), (0.27, 0.37))  # train mode: blue, green


class DragAndDropEnv(e.Env):
    """`engine.Env` with DragAndDrop's motion in place of SelectMove's."""

    def motion(self, actions: np.ndarray) -> np.ndarray:
        """f32[L, 2]: DragAndDrop's (a[2:] - a[:2]) * scale."""
        return (actions[:, 2:] - actions[:, :2]) * self.move_scale

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
            actions = np.asarray(actions, F32)[go]
            motion = self.motion(actions)
            for lane in range(len(go)):
                hit = [i for i in range(s.num[lane])
                       if e.contains_point(e.world_vertices(f[lane, i]),
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
            new.put(go, e.State(f, s.num, count, end,
                                self.rng.child(s.key, 0)))
            step_type[go] = np.where(end, e.LAST, e.MID)
            reward[go] = r
        return new, step_type, reward


def build(precision: str = "float32", image_size=IMAGE_SIZE,
          anti_aliasing: int = ANTI_ALIASING) -> DragAndDropEnv:
    """The demo's environment; `image_size` and `anti_aliasing` change the
    frame only (the tests render it small)."""
    hues = [e.Continuous("c0", lo, hi) for lo, hi in CLUSTERS]
    other = e.Product([
        e.Continuous("x", 0.1, 0.9),
        e.Continuous("y", 0.1, 0.9),
        e.Discrete("shape", ["square", "triangle", "circle"]),
        e.Discrete("scale", [0.13]),
        e.Continuous("c1", 0.3, 1.0),
        e.Continuous("c2", 0.9, 1.0),
    ])
    scene = e.Shuffle(e.Chain(*[e.Generate(e.Product([other, hue]), 2)
                                for hue in hues]))
    task = c.Clustering(hues, terminate_bonus=0.0, reward_range=10.0)
    return DragAndDropEnv(scene, task, max_episode_length=50,
                          image_size=image_size, anti_aliasing=anti_aliasing,
                          move_scale=MOVE_SCALE, precision=precision)
