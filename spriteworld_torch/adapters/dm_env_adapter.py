"""dm_env adapter: a single-environment view onto the batched engine.

Counterpart of `spriteworld_tpu/adapters/dm_env_adapter.py`. Gives the
engine the interface of the reference Environment
(spriteworld/environment.py:27-161): a `dm_env.Environment` with
reset/step/observation_spec/action_spec plus the extra helpers (`success`,
`should_terminate`, `state`, `sample_contained_position`, `observation`,
`action_space`). It steps the port's batched `Environment` at one lane:
actions gain the lane axis on the way in, and observations lose it on the
way out, converted to reference-shaped host values. The SpriteFactors
renderer yields a list of per-sprite factor dicts, SpritePassthrough a list
of `Sprite` objects, Success a Python bool, images uint8 numpy arrays.

As the JAX adapter jits `reset`, `step` and the observation, this one
replays them from CUDA graphs on the card (`core.environment.Compiled` at
one lane; `use_graph=False`, or a CPU env, launches them eagerly). The
adapter is the host boundary: each `reset`, `step` and `observation`
replays its program, then moves the leaves it needs to the host in one
transfer (`utils.device.to_host`), the deferred rejection flag among them,
and raises there what the batched engine can only flag
(`EnvState.sample_ok`, `EnvState.task_valid`). Where the flag is set, the
reset or step runs again eagerly with host-checked rejection from where it
started, and is fetched again. High-throughput consumers step
`core.environment.BatchedEnvironment` or `parallel.ShardedRunner`
directly.

Keys, as in the JAX adapter: the adapter carries a key, `key(seed)` at
construction, and splits it once for the initial state, once a reset and
once a `sample_contained_position`, so the lane's state (its key included)
follows the JAX adapter's from the same seed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import dm_env
from dm_env import specs as dm_specs
import numpy as np
import torch

from spriteworld_torch import sprite as sprite_lib
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import renderers as renderers_lib
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import geometry, lane_random
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling

# Tries of sample_contained_position, and how many of them one CPU call of
# the containment test takes at once.
_MAX_TRIES = 100_000
_TRIES_AT_ONCE = 64


class Environment(dm_env.Environment):
    """Reference-compatible dm_env wrapper around the batched core.

    The constructor mirrors the reference Environment's, plus `device`
    (default "cuda"; "cpu" runs the kernels' plain versions) and
    `use_graph` (replay reset, step and observation from CUDA graphs: by
    default on a CUDA env and not on a CPU env; True on a CPU env raises).
    """

    def __init__(self,
                 task,
                 action_space,
                 renderers: Dict[str, Any],
                 init_sprites,
                 keep_in_frame: bool = True,
                 max_episode_length: int = 1000,
                 metadata: Optional[dict] = None,
                 seed: Optional[int] = None,
                 *,
                 device="cuda",
                 use_graph: Optional[bool] = None):
        self._env = env_lib.Environment(
            task=task,
            action_space=action_space,
            renderers=renderers,
            init_sprites=init_sprites,
            keep_in_frame=keep_in_frame,
            max_episode_length=max_episode_length,
            metadata=metadata,
            device=device,
            seed=0 if seed is None else seed)
        self._key = self._env.root_key()
        self._compiled = env_lib.Compiled(self._env.device, 1, use_graph)
        self._int_actions = isinstance(self._env.action_spec(), list)
        # ONE stable host action space per env (the reference property
        # returns the same object every access). Its rng is seeded from the
        # env seed but is a separate stream: sampling actions must not
        # perturb the episodes.
        self._host_action_space = HostActionSpace(
            self._env.action_space,
            rng=np.random.default_rng(
                None if seed is None else (seed + 0x5EED)))
        # The reference draws a scene at construction and resets on the
        # first step.
        self._state = self._env.initial_state(self._next_key()[None])

    def _next_key(self) -> torch.Tensor:
        """A fresh key int32[2]: the carried key splits into the next
        carried key and this one."""
        keys = lane_random.split(self._key, 2)
        self._key = keys[0]
        return keys[1]

    # ------------------------------------------------------------------ #
    def _fetch(self, observation, **extra):
        """(extra, observation) on the host without the lane axis, in one
        transfer: `extra` maps names to tensors [1, ...], `observation` is a
        renderer-keyed dict of tensors or of dicts of tensors."""
        leaves = {("extra", k): v for k, v in extra.items()}
        for name, value in observation.items():
            if isinstance(value, dict):
                leaves.update({("obs", name, k): v for k, v in value.items()})
            else:
                leaves[("obs", name)] = value
        with profiling.annotate("adapter.fetch"):
            host = device_lib.to_host(leaves)
        out_extra, out_obs = {}, {}
        for key, value in host.items():
            if key[0] == "extra":
                out_extra[key[1]] = value[0]
            elif len(key) == 3:
                out_obs.setdefault(key[1], {})[key[2]] = value[0]
            else:
                out_obs[key[1]] = value[0]
        return out_extra, out_obs

    def _convert_obs(self, obs, n: int):
        out = {}
        for name, renderer in self._env.renderers.items():
            value = obs[name]
            if isinstance(renderer, renderers_lib.SpriteFactors):
                arr = value["factors"]
                out[name] = np.array([
                    {f: float(arr[i, j])
                     for j, f in enumerate(renderer.factor_names)}
                    for i in range(n)
                ])
            elif isinstance(renderer, renderers_lib.SpritePassthrough):
                # The reference passes the Sprite list through: rebuild
                # host-side Sprite objects from the factor rows.
                arr = value["factors"]
                out[name] = np.array(
                    [sprite_lib.from_factor_row(arr[i]) for i in range(n)],
                    dtype=object)
            elif isinstance(renderer, renderers_lib.Success):
                out[name] = bool(value)
            else:
                out[name] = value
        return out

    def _fetch_timestep(self):
        """The current [1]-lane timestep and state flags on the host, with
        the rejection flag where the launch can have set it."""
        ts = self._compiled.timestep
        extra = dict(step_type=ts.step_type, reward=ts.reward,
                     num_sprites=self._state.num_sprites,
                     sample_ok=self._state.sample_ok,
                     task_valid=self._state.task_valid)
        if self._compiled.pending is not None:
            extra["pending"] = self._compiled.pending[None]
        return self._fetch(ts.observation, **extra)

    def _timestep(self, launch) -> dm_env.TimeStep:
        """Launch a reset or step (`launch() -> (state, timestep)`) and
        return its host timestep, after raising what the new state flags;
        where rejection was pending, run it again and fetch again."""
        self._state, _ = launch()
        host, obs = self._fetch_timestep()
        if host.get("pending", False):
            with profiling.annotate("adapter.rerun"):
                self._state, _ = self._compiled.rerun(self._env)
                host, obs = self._fetch_timestep()
        self._check_sample_ok(host)
        obs = self._convert_obs(obs, int(host["num_sprites"]))
        st = int(host["step_type"])
        if st == state_lib.StepType.FIRST:
            return dm_env.restart(obs)
        if st == state_lib.StepType.LAST:
            return dm_env.termination(reward=float(host["reward"]),
                                      observation=obs)
        return dm_env.transition(reward=float(host["reward"]),
                                 observation=obs)

    # ------------------------------------------------------------------ #
    # dm_env.Environment interface
    # ------------------------------------------------------------------ #
    @staticmethod
    def _check_sample_ok(host):
        """Raise at the host boundary what the engine flags: exhausted
        rejection sampling (the reference's ValueError,
        factor_distributions.py:248-249) and a clustering outside
        sklearn's domain (tasks.py:207-215)."""
        if not bool(host["sample_ok"]):
            raise ValueError(
                "Maximum number of tries exceeded when sampling the scene: "
                "the factor distribution is over-constrained and rejection "
                "sampling found no in-support sample within "
                "MAX_REJECTION_TRIES.")
        if not bool(host["task_valid"]):
            # sklearn's davies_bouldin_score raises when the clustering
            # leaves 1 < n_labels < n_samples (fewer than 2 populated
            # clusters, or all-singleton clusters); the reference
            # propagates it.
            raise ValueError(
                "Task is undefined on the current state: the clustering "
                "violates sklearn's 1 < n_labels < n_samples domain (fewer "
                "than 2 populated clusters, or every populated cluster is a "
                "singleton), so the Davies-Bouldin metric does not exist "
                "(the reference's sklearn call raises here). Check the "
                "config's cluster_distribs against its scene distribution.")

    def reset(self) -> dm_env.TimeStep:
        with profiling.annotate("adapter.reset"):
            keys = self._next_key()[None]
            return self._timestep(
                lambda: self._compiled.reset(self._env, keys))

    def step(self, action) -> dm_env.TimeStep:
        with profiling.annotate("adapter.step"):
            dtype = np.int32 if self._int_actions else np.float32
            action = np.asarray(action, dtype=dtype)[None]
            return self._timestep(
                lambda: self._compiled.step(self._env, self._state, action))

    def observation_spec(self):
        spec = {}
        n = int(self._state.num_sprites[0])
        for name, renderer in self._env.renderers.items():
            if isinstance(renderer, renderers_lib.SpriteFactors):
                per_object = {
                    f: dm_specs.Array(shape=(), dtype=np.float32)
                    for f in renderer.factor_names
                }
                spec[name] = [per_object for _ in range(n)]
            elif isinstance(renderer, renderers_lib.SpritePassthrough):
                spec[name] = dm_specs.Array(shape=(n,), dtype=object)
            elif isinstance(renderer, renderers_lib.Success):
                spec[name] = dm_specs.Array(shape=(), dtype=bool)
            elif isinstance(renderer, renderers_lib.ImageRenderer):
                spec[name] = dm_specs.Array(
                    shape=renderer.image_size + (3,), dtype=np.uint8)
            else:
                shape, dtype = renderer.observation_spec()
                spec[name] = dm_specs.Array(
                    shape=shape, dtype=device_lib.numpy_dtype(dtype))
        return spec

    def action_spec(self):
        return self._env.action_spec()

    # ------------------------------------------------------------------ #
    # Reference extras (environment.py:80-161)
    # ------------------------------------------------------------------ #
    def _success(self):
        return self._env.task.success(self._state.factors,
                                      self._state.num_sprites)

    def success(self) -> bool:
        return bool(device_lib.to_host({"s": self._success()})["s"][0])

    def should_terminate(self) -> bool:
        s = self._state
        host = device_lib.to_host({
            "success": self._success(),
            "oof": geometry.out_of_frame(s.factors, s.num_sprites),
            "step_count": s.step_count})
        timeout = int(host["step_count"][0]) >= self._env.max_episode_length
        return bool(host["success"][0]) or bool(host["oof"][0]) or timeout

    def state(self, as_sprites: bool = False):
        """Reference-style state dict (environment.py:128-134).

        `as_sprites=True` returns host Sprite objects (the reference form);
        the default stays the raw factor-row array for engine consumers.
        """
        host = device_lib.to_host({
            "success": self._success(),
            "num_sprites": self._state.num_sprites,
            "factors": self._state.factors})
        global_state = {"success": bool(host["success"][0])}
        if self._env.metadata:
            global_state["metadata"] = self._env.metadata
        rows = host["factors"][0, :int(host["num_sprites"][0])]
        sprites = ([sprite_lib.from_factor_row(r) for r in rows]
                   if as_sprites else rows)
        return {"sprites": sprites, "global_state": global_state}

    def sample_contained_position(self) -> np.ndarray:
        """Random position inside a random sprite (environment.py:110-126).

        A numpy generator seeded from the adapter's next key picks the
        sprite and draws points in its bounding box until one lies inside;
        the
        containment test is `geometry.points_in_polygons` on the host
        copy of the vertices, `_TRIES_AT_ONCE` draws a call. The draws
        come from the numpy stream in the same order one at a time would,
        so the first point inside is the one the one-at-a-time loop finds.
        """
        host = device_lib.to_host({
            "factors": self._state.factors[0],
            "num_sprites": self._state.num_sprites[0],
            "seed": lane_random.randint(self._next_key(), 1, 0,
                                        2**31 - 1)[0]})
        rng = np.random.default_rng(int(host["seed"]))
        idx = rng.integers(0, int(host["num_sprites"]))
        verts = geometry.world_vertices(torch.from_numpy(
            host["factors"][idx].copy()))
        lo, hi = verts.min(0).values.numpy(), verts.max(0).values.numpy()
        for start in range(0, _MAX_TRIES, _TRIES_AT_ONCE):
            count = min(_TRIES_AT_ONCE, _MAX_TRIES - start)
            points = rng.uniform(lo, hi, size=(count, 2))
            inside = geometry.points_in_polygons(
                verts, torch.from_numpy(points.astype(np.float32))).numpy()
            if inside.any():
                return points[int(inside.argmax())]
        raise ValueError("max_tries exceeded in sample_contained_position")

    def observation(self):
        """Render the current state off-cycle (environment.py:136-142):
        the compiled observation of the current state, converted to
        reference-shaped host values."""
        obs = self._compiled.observe(self._env, self._state)
        self._state = self._compiled.state
        host, obs = self._fetch(obs, num_sprites=self._state.num_sprites)
        return self._convert_obs(obs, int(host["num_sprites"]))

    @property
    def action_space(self):
        return self._host_action_space


class HostActionSpace:
    """Reference-shaped view of an engine action space.

    The engine's `sample(generator, batch)` returns device tensors (int32
    for Embodied); reference-compatible agents instead call
    `action_space.sample()` with no arguments and pass the result straight
    to `dm_env` spec validation. This wrapper samples on the host with a
    numpy generator and returns values that `spec.validate` accepts: a list
    of int64 scalars for the Embodied list-spec, a float32 vector for the
    click spaces. Everything else forwards to the wrapped engine space.
    """

    def __init__(self, space, rng=None):
        self._space = space
        self._rng = rng if rng is not None else np.random.default_rng()

    def action_spec(self):
        return self._space.action_spec()

    def sample(self):
        spec = self._space.action_spec()
        if isinstance(spec, (list, tuple)):  # Embodied: per-entry scalars
            return [s.dtype.type(self._rng.integers(0, s.num_values))
                    for s in spec]
        return self._rng.uniform(
            spec.minimum, spec.maximum,
            size=spec.shape).astype(spec.dtype)

    def __getattr__(self, name):
        return getattr(self._space, name)
