"""OpenAI Gym adapter for the dm_env view of the engine.

Counterpart of `spriteworld_tpu/adapters/gym_adapter.py`, a rebuild of the
reference's gym_wrapper.py:26-135. `gym` is an optional dependency of the
reference and is not present in every installation, so it (and dm_env's
specs) is imported when a space or wrapper is built.
"""

from __future__ import annotations

import numpy as np


def _gym():
    try:
        import gym
        from gym import spaces
    except ImportError as e:  # pragma: no cover - environment without gym
        raise ImportError(
            "gym is required for GymWrapper; install the 'gym' extra.") from e
    return gym, spaces


def spec_to_space(spec):
    """Convert a dm_env spec (or list of them) to a Gym space
    (reference gym_wrapper.py:26-39)."""
    _, spaces = _gym()
    from dm_env import specs as dm_specs

    if isinstance(spec, list):
        return spaces.Tuple([spec_to_space(s) for s in spec])
    if isinstance(spec, dm_specs.DiscreteArray):
        return spaces.Discrete(spec.num_values)
    if isinstance(spec, dm_specs.BoundedArray):
        return spaces.Box(
            low=float(np.min(spec.minimum)),
            high=float(np.max(spec.maximum)),
            shape=spec.shape, dtype=spec.dtype)
    if isinstance(spec, dm_specs.Array):
        return spaces.Box(low=-np.inf, high=np.inf, shape=spec.shape,
                          dtype=spec.dtype)
    raise ValueError(f"Unsupported spec type {type(spec)}")


class GymWrapper:
    """dm_env -> Gym environment (reference gym_wrapper.py:42-135)."""

    metadata = {"render.modes": ["rgb_array"]}

    def __init__(self, env):
        gym, spaces = _gym()
        self._env = env
        self._last_image = None
        # Reference resets at construction to materialize data-dependent
        # observation specs (gym_wrapper.py:57-58).
        self._env.reset()
        self.action_space = spec_to_space(self._env.action_spec())
        obs_spec = self._env.observation_spec()
        space_dict = {}
        for name, spec in obs_spec.items():
            if isinstance(spec, list):  # per-sprite factor dicts
                n = len(spec)
                f = len(spec[0]) if n else 0
                space_dict[name] = spaces.Box(
                    low=-np.inf, high=np.inf, shape=(n, f),
                    dtype=np.float32)
            else:
                try:
                    space_dict[name] = spec_to_space(spec)
                except ValueError:
                    space_dict[name] = spaces.Box(
                        low=-np.inf, high=np.inf, shape=spec.shape,
                        dtype=np.float32)
        self.observation_space = spaces.Dict(space_dict)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _convert_obs(self, observation):
        out = {}
        for name, value in observation.items():
            if isinstance(value, np.ndarray) and value.dtype == object:
                # list of factor dicts -> [N, F] float array
                out[name] = np.array(
                    [[v for v in d.values()] for d in value],
                    dtype=np.float32)
            elif isinstance(value, (bool, np.bool_)):
                out[name] = np.float32(value)
            else:
                out[name] = np.asarray(value)
                if name == "image":
                    self._last_image = out[name]
        return out

    def reset(self):
        timestep = self._env.reset()
        return self._convert_obs(timestep.observation)

    def step(self, action):
        timestep = self._env.step(action)
        obs = self._convert_obs(timestep.observation)
        reward = timestep.reward if timestep.reward is not None else 0.0
        done = timestep.last()
        info = {"discount": timestep.discount}
        return obs, reward, done, info

    def render(self, mode="rgb_array"):
        if mode != "rgb_array":
            raise ValueError(f"Unsupported render mode {mode}")
        return self._last_image
