"""Episode recording and GIF export.

Counterpart of `spriteworld_tpu/utils/media.py`: roll out one env lane with
image observations and write the frames as an animated GIF (Pillow,
imported by `save_gif` only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spriteworld_torch.core.state import StepType
from spriteworld_torch.utils import device as device_lib


def step_frame(env, state, action, obs_key: str = "image"):
    """One step of a one-lane rollout: (state, frame u8[H, W, 3], last).

    Steps the batched engine at B=1 and moves the frame and the LAST flag
    to the host in one transfer: the one wait for the device a step.
    """
    state, ts = env.step_batch(state, torch.as_tensor(action,
                                                      device=env.device))
    host = device_lib.to_host({"frame": ts.observation[obs_key][0],
                               "last": ts.step_type[0] == StepType.LAST})
    return state, host["frame"], bool(host["last"])


def record_episode(env, generator_or_seed, max_steps: int = 100,
                   obs_key: str = "image", policy=None,
                   return_states: bool = False):
    """Roll out one env lane; returns stacked frames u8[T, H, W, 3].

    Runs the batched engine with B=1 (the single-lane view the demo UI
    uses), stepping until the episode's LAST timestep or `max_steps`.
    `generator_or_seed` is the `torch.Generator` the policy draws from, or
    an int: then the env's own generator is seeded with it, so the scene
    and the default policy's actions repeat for one seed.
    `policy(generator, state) -> action[1, ...]` (a tensor or an array)
    defaults to the env's uniform random sampler (the reference
    RandomAgent). With `return_states`, returns (frames, states): the
    EnvState of every frame, the reset's first.
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

    state, ts = env.reset_batch(1)
    frames = [device_lib.to_host({"f": ts.observation[obs_key][0]})["f"]]
    states = [state]
    for _ in range(max_steps):
        state, frame, last = step_frame(env, state, policy(generator, state),
                                        obs_key)
        frames.append(frame)
        states.append(state)
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
