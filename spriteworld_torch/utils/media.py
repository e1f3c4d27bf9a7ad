"""Episode recording and GIF export.

Counterpart of `spriteworld_tpu/utils/media.py`: roll out one env lane with
image observations and write the frames as an animated GIF (Pillow,
imported by `save_gif` only). As the JAX package jits `reset_batch` and
`step_batch` once per env, the one-lane reset and step here are compiled
once per env (`core.environment.Compiled`: CUDA graphs on the card) and
replayed for every step and episode.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core.state import StepType
from spriteworld_torch.core.step_graph import use_graph_for
from spriteworld_torch.utils import device as device_lib

# The compiled one-lane programs of each env, by use_graph; they hold no
# reference to the env, so an entry goes with its env.
_COMPILED = weakref.WeakKeyDictionary()


def _compiled(env, use_graph: Optional[bool]) -> env_lib.Compiled:
    use_graph = use_graph_for(env.device, use_graph)
    programs = _COMPILED.setdefault(env, {})
    if use_graph not in programs:
        programs[use_graph] = env_lib.Compiled(env.device, 1, use_graph)
    return programs[use_graph]


def _frame(env, compiled, launch, obs_key):
    """Launch a reset or step of one lane (`launch() -> (state, ts)`) and
    move its frame, its LAST flag and the rejection flag to the host in one
    transfer; where rejection was pending, run it again and fetch again.
    Returns (state, frame u8[H, W, 3], last)."""
    def fetch(ts):
        leaves = {"frame": ts.observation[obs_key][0],
                  "last": ts.step_type[0] == StepType.LAST}
        if compiled.pending is not None:
            leaves["pending"] = compiled.pending
        return device_lib.to_host(leaves)

    state, ts = launch()
    host = fetch(ts)
    if host.get("pending", False):
        state, ts = compiled.rerun(env)
        host = fetch(ts)
    return state, host["frame"], bool(host["last"])


def step_frame(env, state, action, obs_key: str = "image",
               use_graph: Optional[bool] = None):
    """One step of a one-lane rollout: (state, frame u8[H, W, 3], last).

    Replays the env's compiled one-lane step (on a CUDA env by default; see
    `record_episode`) and moves the frame and the LAST flag to the host in
    one transfer: the one wait for the device a step. The returned state
    is the compiled step's state buffer, which the next step overwrites.
    """
    compiled = _compiled(env, use_graph)
    return _frame(env, compiled,
                  lambda: compiled.step(env, state, action), obs_key)


def record_episode(env, generator_or_seed, max_steps: int = 100,
                   obs_key: str = "image", policy=None,
                   return_states: bool = False,
                   use_graph: Optional[bool] = None):
    """Roll out one env lane; returns stacked frames u8[T, H, W, 3].

    Runs the batched engine with B=1 (the single-lane view the demo UI
    uses), stepping until the episode's LAST timestep or `max_steps`.
    `generator_or_seed` is the `torch.Generator` the policy draws from, or
    an int: then the env's own generator is seeded with it, so the scene
    and the default policy's actions repeat for one seed.
    `policy(generator, state) -> action[1, ...]` (a tensor or an array)
    defaults to the env's uniform random sampler (the reference
    RandomAgent); it runs outside the graph, between replays, and its
    action is copied into the compiled step's action buffer. With
    `return_states`, returns (frames, states): copies of the EnvState of
    every frame, the reset's first. `use_graph` replays the reset and the
    step from CUDA graphs, captured once per env (the default on a CUDA
    env; True on a CPU env raises).
    """
    if isinstance(generator_or_seed, torch.Generator):
        generator = generator_or_seed
    else:
        generator = env.generator
        generator.manual_seed(int(generator_or_seed))
    if policy is None:
        def policy(g, state):
            del state
            return env.action_space.sample(g, 1)

    compiled = _compiled(env, use_graph)
    state, frame, _ = _frame(env, compiled, lambda: compiled.reset(env),
                             obs_key)
    frames = [frame]
    states = [state.clone()] if return_states else None
    for _ in range(max_steps):
        action = policy(generator, state)
        state, frame, last = _frame(
            env, compiled, lambda: compiled.step(env, state, action),
            obs_key)
        frames.append(frame)
        if return_states:
            states.append(state.clone())
        if last:
            break
    frames = np.stack(frames)
    return (frames, states) if return_states else frames


def save_gif(frames: np.ndarray, path: str, fps: float = 10,
             scale: Optional[int] = None) -> str:
    """Write u8[T, H, W, 3] frames as an animated GIF; returns `path`.

    `scale` integer-upscales with nearest-neighbor (64x64 observations
    are small; the reference demos render at 256).
    """
    from PIL import Image

    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected u8[T, H, W, 3], got {frames.shape}")
    if scale:
        frames = frames.repeat(scale, axis=1).repeat(scale, axis=2)
    imgs = [Image.fromarray(f) for f in frames.astype(np.uint8)]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path
