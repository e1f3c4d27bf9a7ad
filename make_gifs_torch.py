"""Episode GIFs from the PyTorch port, with scripted greedy agents.

Counterpart of `make_gifs.py`: each GIF shows a task being solved by a
scripted agent that clicks the worst-placed sprite and drags it toward its
goal (goal finding, sorting) or toward an anchor of its cluster
(clustering). The agents read the state from the device once a step.

  python make_gifs_torch.py [--device cpu] [--out_dir gifs_torch]

writes clustering_video.gif, goal_finding_video.gif and sorting_video.gif
into --out_dir (default `gifs_torch/`, which git ignores; the reference
GIFs under `gifs/` are the JAX package's). Needs Pillow.
"""

from __future__ import annotations

import argparse
import importlib
import os

import numpy as np
import torch

from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import tasks
from spriteworld_torch.ops import geometry
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import media

_SELECT_MOVE_SCALE = 0.25  # configs/cobra/common.py action space
# Cap the per-step drag so the GIFs show visible progress instead of a
# 1-3 step teleport (|motion| <= _SPEED_CAP * scale per step).
_SPEED_CAP = 0.14
_IDLE = np.array([[0.0, 0.0, 0.5, 0.5]], np.float32)  # a click on nothing


def _capped(delta: np.ndarray) -> np.ndarray:
    norm = float(np.linalg.norm(delta))
    if norm > _SPEED_CAP:
        delta = delta * (_SPEED_CAP / norm)
    return delta


def _topmost_at(factors, num_sprites, points):
    """Which sprite would a click at each of `points` f32[P, 2] select
    (SelectMove's topmost rule) in the one-lane scene `factors` [1, K, 10]?
    Returns (index, any_hit) on the host, each [P]."""
    p = points.shape[0]
    f = factors.expand(p, -1, -1)
    hits = geometry.sprites_containing_point(f, points)
    idx, hit = geometry.topmost_hit(hits, num_sprites.expand(p))
    host = device_lib.to_host({"idx": idx, "hit": hit})
    return host["idx"], host["hit"]


def _act_toward(candidates, factors, num_sprites):
    """The first candidate (sprite k, its position, target) whose click
    would select k, as a drag toward its target (sprites crossing paths
    occlude each other; clicking through the occluder moves the wrong
    sprite and the agents deadlock); the idle action if none would."""
    if not candidates:
        return _IDLE
    pos = np.stack([c[1] for c in candidates]).astype(np.float32)
    idx, hit = _topmost_at(factors, num_sprites,
                           torch.as_tensor(pos, device=factors.device))
    for (k, p, target), i, h in zip(candidates, idx, hit):
        if h and int(i) == int(k):
            delta = _capped(np.clip((target - p) / _SELECT_MOVE_SCALE,
                                    -0.5, 0.5))
            return np.concatenate([p, 0.5 + delta])[None].astype(np.float32)
    return _IDLE


def _goal_policy(env):
    """Greedy SelectMove agent for FindGoalPosition / MetaAggregated tasks:
    click the filtered sprite farthest outside its terminate distance and
    drag it toward its subtask's goal (clipped to the action-space scale)."""
    task = env.task
    subs = ([task] if isinstance(task, tasks.FindGoalPosition)
            else list(task._subtasks))
    goals = np.stack([np.asarray(t._goal_position) for t in subs])

    def policy(keys, state):
        del keys
        f, n = state.factors, state.num_sprites
        host = device_lib.to_host({
            "masks": torch.stack([t.filter_mask(f, n)[0] for t in subs]),
            "deficits": torch.stack([
                -t._per_sprite_rewards(f)[0] / t._raw_reward_multiplier
                for t in subs]),
            "factors": f[0]})
        deficits = np.where(host["masks"], host["deficits"], -np.inf)
        flat = np.argsort(-deficits, axis=None, kind="stable")
        candidates = []
        for si, ki in zip(*np.unravel_index(flat, deficits.shape)):
            if deficits[si, ki] <= 0:
                break  # the rest are in place
            candidates.append((ki, host["factors"][ki, 0:2], goals[si]))
        return _act_toward(candidates, f, n)

    return policy


def _clustering_policy(env):
    """Greedy SelectMove agent for the Clustering task: drag each sprite
    toward a fixed well-separated anchor for its cluster until the
    Davies-Bouldin metric clears the termination threshold."""
    task = env.task
    anchors = np.array([[0.22, 0.30], [0.78, 0.70],
                        [0.22, 0.70], [0.78, 0.30]], np.float32)

    def policy(keys, state):
        del keys
        f, n = state.factors, state.num_sprites
        host = device_lib.to_host({"member": task.membership(f, n)[0],
                                   "factors": f[0]})
        k_idx, c_idx = np.nonzero(host["member"])
        # Same-cluster sprites get slightly offset targets so they gather
        # around the anchor instead of stacking (a stacked sprite occludes
        # its cluster-mate's click point).
        offsets = (np.stack([k_idx % 2, (k_idx // 2) % 2], -1) - 0.5) * 0.09
        targets = anchors[c_idx] + offsets
        pos = host["factors"][k_idx, 0:2]
        dists = np.linalg.norm(pos - targets, axis=-1)
        candidates = []
        for j in np.argsort(-dists, kind="stable"):
            if dists[j] < 0.02:
                break
            candidates.append((k_idx[j], pos[j], targets[j]))
        return _act_toward(candidates, f, n)

    return policy


CONFIGS = {
    "goal_finding_video": (
        "spriteworld_torch.configs.cobra.goal_finding_new_shape",
        _goal_policy),
    "clustering_video": (
        "spriteworld_torch.configs.cobra.clustering", _clustering_policy),
    "sorting_video": (
        "spriteworld_torch.configs.cobra.sorting", _goal_policy),
}


def record(name: str, seed: int, device="cuda", max_steps: int = 60):
    """The frames u8[T, H, W, 3] of one scripted episode of `name`."""
    module, policy_fn = CONFIGS[name]
    config = importlib.import_module(module).get_config("train")
    env = env_lib.Environment(**config, device=device)
    return media.record_episode(env, seed, max_steps=max_steps,
                                policy=policy_fn(env))


def make_gif(name: str, out_dir: str, seed: int, scale: int,
             device="cuda", max_steps: int = 60) -> str:
    """Record one scripted episode of `name` and write it as a GIF."""
    frames = record(name, seed, device, max_steps)
    path = os.path.join(out_dir, f"{name}.gif")
    media.save_gif(frames, path, fps=8, scale=scale)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out_dir", default="gifs_torch",
                   help="Output directory.")
    p.add_argument("--scale", type=int, default=3,
                   help="Nearest-neighbour upscale factor.")
    p.add_argument("--seed", type=int, default=1, help="Episode seed.")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cpu' runs the kernels' plain "
                        "versions).")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for name in CONFIGS:
        print(make_gif(name, args.out_dir, args.seed, args.scale,
                       args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
