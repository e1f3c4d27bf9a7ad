"""The environment core: batched reset/step with per-lane auto-reset.

Counterpart of `spriteworld_tpu/core/environment.py`, batch-native. The
`Environment` holds static configuration (task, action space, renderers,
scene generator, episode limits) and the device; dynamic state lives in an
:class:`EnvState` with a leading lane axis, each lane's random key
included. As in the JAX package, a fresh scene splits the lane's key into
the scene's key and the next key, and a step splits it into the next key
and the action's key (`ops.lane_random`), so a step is a function of its
state and actions, and a lane's episode depends on its key alone.

Step pipeline (reference environment.py:88-108, preserved order):
  action cost -> velocity integration -> task reward -> observation ->
  terminate on success | out-of-frame | timeout.

Auto-reset: a step on a lane whose previous step was LAST resamples that
lane's scene and emits FIRST — including the reference quirk that the first
`step_batch` from `initial_state` performs a reset (reset_next=True). As in
the JAX package's `transition` under vmap, every step samples a fresh scene
for every lane and the lanes with reset_next select it (`torch.where`), so
the step never asks the host which lanes those are: it makes no host sync
and can be captured in a CUDA graph (`parallel.runner`). Each step renders
once, the selected state.

The single-lane methods (`reset`, `step`, `transition`, `success`) are the
batched ones at one lane; `observation` calls each renderer's one-scene
`render`, and `observation_batch` its `render_batch`, as in the JAX
package. Every action is cast to its action space's dtype
(`action_shape_dtype`) on the way in, as the JAX package with x64 off
takes a float64 array as float32; an action space without that property
(one written for the JAX package, which never reads it) gets JAX's rule:
float64 as float32, int64 as int32. `BatchedEnvironment` replays
its reset and step as CUDA graphs (`Compiled`), as the JAX package jits
them; the dm_env adapter and `utils/media.py` replay the same programs at
one lane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from spriteworld_torch.core.state import (STATE_FIELDS, EnvState, StepType,
                                          TimeStep)
from spriteworld_torch.core.step_graph import StepGraph, use_graph_for
from spriteworld_torch.core.tasks import REWARD, SUCCESS, VALID, Evaluator
from spriteworld_torch.ops import geometry, lane_random
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling

# The dtypes JAX with x64 off takes 64-bit arrays as.
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32}


def _map(fn, tree):
    """`fn` over the tensors of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy(dst, src):
    """Copies the tensors of `src` into those of `dst`: two nested dicts,
    EnvStates or TimeSteps of one structure."""
    if dataclasses.is_dataclass(dst):
        dst, src = vars(dst), vars(src)
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy(v, src[k])
    else:
        dst.copy_(src)


def _map_state(fn, state: EnvState) -> EnvState:
    return EnvState(**{n: fn(getattr(state, n)) for n in STATE_FIELDS})


def _map_timestep(fn, ts: TimeStep) -> TimeStep:
    return TimeStep(step_type=fn(ts.step_type), reward=fn(ts.reward),
                    discount=fn(ts.discount),
                    observation=_map(fn, ts.observation))


def _first_lane(x):
    return x[0]


def _lane_axis(x):
    return x[None]


class Environment:
    """Static environment configuration + batched transition functions.

    The constructor mirrors the reference Environment.__init__ so config
    dicts translate one-to-one, plus `device` (default "cuda") and `seed`:
    where a reset or an initial state is given a number of lanes B instead
    of their keys, the lanes take `split(key(seed), B)`, and a key argument
    left out is `key(seed)`.
    """

    def __init__(self,
                 task,
                 action_space,
                 renderers: Dict[str, Any],
                 init_sprites,
                 keep_in_frame: bool = True,
                 max_episode_length: int = 1000,
                 metadata: Optional[dict] = None,
                 *,
                 device="cuda",
                 seed: int = 0):
        self._task = task
        # The task's evaluation at the step's call sites: one launch of the
        # task kernel a site where its tree has a table (`tasks.Evaluator`).
        self._evaluator = Evaluator(task)
        self._action_space = action_space
        self._renderers = dict(renderers)
        self._init_sprites = init_sprites
        self._keep_in_frame = bool(keep_in_frame)
        self._max_episode_length = int(max_episode_length)
        self._metadata = metadata
        self.device = device_lib.resolve(device)
        self.seed = int(seed)
        for r in self._renderers.values():
            r.bind(init_sprites.max_sprites)

    @property
    def max_sprites(self) -> int:
        return self._init_sprites.max_sprites

    @property
    def task(self):
        return self._task

    @property
    def action_space(self):
        return self._action_space

    @property
    def renderers(self):
        return self._renderers

    @property
    def metadata(self):
        return self._metadata

    @property
    def max_episode_length(self) -> int:
        return self._max_episode_length

    def action_spec(self):
        return self._action_space.action_spec()

    def observation_spec(self):
        return {name: r.observation_spec()
                for name, r in self._renderers.items()}

    def _action_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The dtype an action of `dtype` is cast to on its way into a step:
        the action space's `action_shape_dtype`, or JAX's x64-off rule for
        an action space without one."""
        spec = getattr(self._action_space, "action_shape_dtype", None)
        return spec[1] if spec is not None else _X64_OFF.get(dtype, dtype)

    def observation_batch(self, factors, num_sprites, success):
        return {name: r.render_batch(factors, num_sprites, success)
                for name, r in self._renderers.items()}

    # Single-lane methods: the batched ones at one lane (the lane axis is
    # added on the way in and removed on the way out).
    def observation(self, factors, num_sprites, success):
        """The renderers' observation of one scene (each one's `render`)."""
        return {name: r.render(factors, num_sprites, success)
                for name, r in self._renderers.items()}

    def success(self, state: EnvState):
        """The task's success flag (bool[]) on one lane's state."""
        return self.task_success(state.factors[None],
                                 state.num_sprites[None], "success")[0]

    def task_success(self, factors, num_sprites, site: str):
        """The task's success flags bool[B] of B scenes, evaluated at call
        site `site` (`tasks.Evaluator`)."""
        return self._evaluator.evaluate(factors, num_sprites, SUCCESS,
                                        site)[1]

    def root_key(self, key=None) -> torch.Tensor:
        """One key int32[2] on the env's device: `key` itself (a key), the
        key of a seed (an int), or `key(self.seed)` (None)."""
        return lane_random.as_key(self.seed if key is None else key,
                                  self.device)

    def lane_keys(self, keys) -> torch.Tensor:
        """Lane keys int32[B, 2] on the env's device: `keys` itself, or,
        for a number of lanes B, `split(key(self.seed), B)`."""
        if isinstance(keys, int):
            return lane_random.split(self.root_key(), keys)
        if keys.dim() != 2 or keys.shape[-1] != 2:
            raise ValueError(f"lane keys are int32[B, 2], got "
                             f"{tuple(keys.shape)}")
        return keys.to(self.device, torch.int32)

    def reset(self, key=None):
        """Sample a fresh scene from `key` (a key int32[2], or an int
        seed; None is `self.seed`); returns (EnvState, FIRST TimeStep) of
        one lane."""
        state, ts = self.reset_batch(self.root_key(key)[None])
        return (_map_state(_first_lane, state),
                _map_timestep(_first_lane, ts))

    def transition(self, state: EnvState, action):
        """One lane's transition with auto-reset, no observation: (EnvState,
        TimeStep whose observation is ())."""
        new, ts = self._transition_batch(_map_state(_lane_axis, state),
                                         self._action(action))
        return _map_state(_first_lane, new), TimeStep(
            step_type=ts.step_type[0], reward=ts.reward[0],
            discount=ts.discount[0], observation=())

    def step(self, state: EnvState, action):
        """One lane's transition plus observation: (EnvState, TimeStep)."""
        new, ts = self.step_batch(_map_state(_lane_axis, state),
                                  self._action(action))
        return _map_state(_first_lane, new), _map_timestep(_first_lane, ts)

    def _action(self, action):
        """One lane's action as a [1, ...] tensor of the action space's
        dtype on the env's device."""
        action = torch.as_tensor(action)
        return action.to(self.device, self._action_dtype(action.dtype))[None]

    def _fresh(self, split_keys: torch.Tensor, reset_next: bool) -> EnvState:
        """Fresh scenes of lanes whose keys split into `split_keys`
        int32[B, 2, 2]: the scene's key, then the state's next key."""
        with profiling.annotate("env.fresh"):
            batch = split_keys.shape[0]
            factors, num, ok = self._init_sprites.sample_with_status(
                split_keys[:, 0])
            with profiling.annotate("env.task"):
                _, _, valid = self._evaluator.evaluate(factors, num, VALID,
                                                       "fresh")
            return EnvState(
                factors=factors,
                num_sprites=num,
                step_count=torch.zeros(batch, dtype=torch.int32,
                                       device=self.device),
                reset_next=torch.full((batch,), reset_next,
                                      dtype=torch.bool, device=self.device),
                key=split_keys[:, 1],
                sample_ok=ok,
                task_valid=valid)

    def reset_batch(self, keys):
        """Sample B fresh scenes from lane keys `keys` int32[B, 2] (or a
        number of lanes; see `lane_keys`); returns (EnvState, FIRST
        TimeStep)."""
        keys = self.lane_keys(keys)
        batch = keys.shape[0]
        state = self._fresh(lane_random.split(keys, 2), reset_next=False)
        obs = self._render(state)
        ts = TimeStep(
            step_type=torch.full((batch,), StepType.FIRST, dtype=torch.int32,
                                 device=self.device),
            reward=torch.zeros(batch, device=self.device),
            discount=torch.ones(batch, device=self.device),
            observation=obs)
        return state, ts

    def initial_state(self, keys) -> EnvState:
        """State of B freshly constructed reference Environments from lane
        keys `keys` (or a number of lanes): sprites sampled, and the first
        step still resets (reset_next=True)."""
        return self._fresh(lane_random.split(self.lane_keys(keys), 2),
                           reset_next=True)

    def _transition_batch(self, state: EnvState, actions: torch.Tensor):
        """One transition of every lane, no render: (state, TimeStep whose
        observation is ())."""
        with profiling.annotate("env.transition"):
            # One split serves both branches, as in the JAX package: a
            # stepping lane carries the first key on and acts with the
            # second; a resetting lane draws its scene from the first and
            # carries the second on.
            split_keys = lane_random.split(state.key, 2)
            with profiling.annotate("env.action"):
                factors, cost = self._action_space.step(
                    actions.to(self._action_dtype(actions.dtype)),
                    state.factors, state.num_sprites, self._keep_in_frame,
                    split_keys[:, 1])
            # Velocity integration for every sprite; dead slots carry zero
            # velocity so padding is unaffected.
            new_pos = factors[..., 0:2] + factors[..., 8:10]
            if self._keep_in_frame:
                new_pos = new_pos.clamp(0.0, 1.0)
            factors[..., 0:2] = new_pos
            num = state.num_sprites

            with profiling.annotate("env.task"):
                task_reward, success, valid = self._evaluator.evaluate(
                    factors, num, REWARD | SUCCESS | VALID, "transition")
                reward = cost + task_reward
            oof = geometry.out_of_frame(factors, num)
            step_count = state.step_count + 1
            terminate = success | oof | (
                step_count >= self._max_episode_length)
            stepped = EnvState(
                factors=factors,
                num_sprites=num,
                step_count=step_count,
                reset_next=terminate,
                key=split_keys[:, 0],
                sample_ok=state.sample_ok,
                task_valid=valid)

            # Lanes that ended last step start a new episode instead.
            reset = state.reset_next
            fresh = self._fresh(split_keys, reset_next=False)

            def select(a, b):
                return torch.where(
                    reset.view((-1,) + (1,) * (a.dim() - 1)), a, b)

            new = EnvState(**{name: select(getattr(fresh, name),
                                           getattr(stepped, name))
                              for name in STATE_FIELDS})
            step_type = torch.where(
                reset, StepType.FIRST,
                torch.where(terminate, StepType.LAST, StepType.MID)).to(
                    torch.int32)
            reward = torch.where(reset, 0.0, reward)
            discount = torch.where(reset | ~terminate, 1.0, 0.0)
        return new, TimeStep(step_type=step_type, reward=reward,
                             discount=discount, observation=())

    def step_batch(self, state: EnvState, actions: torch.Tensor):
        """One transition of every lane plus one render: (state, TimeStep).

        Lanes whose previous step was LAST take a fresh scene and emit FIRST
        (reward 0, discount 1) instead of stepping. `actions` take the
        action space's dtype."""
        new, ts = self._transition_batch(state, actions)
        return new, dataclasses.replace(ts, observation=self._render(new))

    def _render(self, state: EnvState):
        """The renderers' observation of `state`, its success flag taken
        from the task."""
        with profiling.annotate("env.render"):
            with profiling.annotate("env.task"):
                success = self.task_success(state.factors,
                                            state.num_sprites, "render")
            return self.observation_batch(state.factors, state.num_sprites,
                                          success)

    def sample_action(self, key: torch.Tensor):
        """Random actions [B, ...], one a lane key of `key` int32[B, 2]."""
        return self._action_space.sample(key)


def _may_pend(program: StepGraph) -> bool:
    """Whether a launch of `program` can set the rejection flag."""
    return program.graph is None or program.rejects


class Compiled:
    """The reset, step and observation of `lanes` lanes of an Environment,
    each a `StepGraph`: replayed from a CUDA graph captured at its first
    call, as the JAX package jits `reset_batch`, `step_batch` and the
    observation, or launched eagerly without a graph (the default on a CPU
    environment; `use_graph=True` there raises).

    The programs read and write static buffers: `state`, an EnvState of
    [lanes, ...] tensors (the lanes' keys among them) that reset and step
    write and step and observe read; the reset's lane keys; the actions;
    `timestep`, the last reset's or step's TimeStep; and the observation
    that `observe` writes. `reset` copies its keys into the key buffer,
    `step` copies `state` into the state buffers unless it is their own
    object, and `actions` into the action buffer (one host-to-device copy
    for an array). A caller reads a program's results before it launches
    the next, which overwrites them.

    Rejection: every program runs deferred: a rejection node that still
    has elements after its first rounds sets the device flag `pending`
    instead of asking the host. `pending` is None where no launch can set
    it (a captured program that holds no rejection node); a caller that
    reads it set calls `rerun()`, which restores the state that the last
    launch started from (each step saves its start state on the device;
    the keys are part of it) and runs that program again eagerly with
    host-checked rejection, continuing the same draws. Without a graph,
    `pending` is read after every launch; with one, only where the captured
    program holds a rejection node (JAX's `lax.while_loop` reads nothing).

    The programs hold no reference to the environment, which every call
    passes in: a cache keyed weakly by the environment (`utils/media.py`)
    stays weak, and no reference cycle runs through a graph (the garbage
    collector could free such a graph during another capture).
    """

    def __init__(self, device, lanes: int, use_graph: Optional[bool] = None):
        self.lanes = int(lanes)
        self.device = torch.device(device)
        self.use_graph = use_graph_for(self.device, use_graph)
        self.state: Optional[EnvState] = None
        self.timestep: Optional[TimeStep] = None
        self._start: Optional[EnvState] = None
        self._keys: Optional[torch.Tensor] = None
        self._actions: Optional[torch.Tensor] = None
        self._obs = None
        self._pending = torch.zeros((), dtype=torch.bool, device=self.device)
        self._programs: Dict[str, StepGraph] = {}
        self._last: Optional[str] = None  # the program launched last
        # Launches run again eagerly because `pending` was set.
        self.reruns = 0

    # The programs' bodies.
    def _reset(self, env):
        self._pending.zero_()
        self._store(*env.reset_batch(self._keys))

    def _step(self, env):
        self._pending.zero_()
        _copy(self._start, self.state)
        self._store(*env.step_batch(self.state, self._actions))

    def _observe(self, env):
        self._pending.zero_()
        s = self.state
        obs = env.observation_batch(s.factors, s.num_sprites,
                                    env.task_success(s.factors,
                                                     s.num_sprites,
                                                     "observe"))
        if self._obs is None:
            self._obs = _map(torch.clone, obs)
        else:
            _copy(self._obs, obs)

    def _store(self, state: EnvState, ts: TimeStep):
        if self.state is None:
            self._alloc_state(state)
        else:
            _copy(self.state, state)
        if self.timestep is None:
            self.timestep = _map_timestep(torch.clone, ts)
        else:
            _copy(self.timestep, ts)

    def _alloc_state(self, like: EnvState):
        self.state = like.clone()
        self._start = like.clone()

    # Loading the inputs.
    def _load_state(self, state: EnvState):
        if self.state is None:
            self._alloc_state(state)
        elif state is not self.state:
            for n in STATE_FIELDS:
                buf, x = getattr(self.state, n), getattr(state, n)
                if buf.shape != x.shape or buf.dtype != x.dtype:
                    raise ValueError(
                        f"state field {n} of shape {tuple(x.shape)} and "
                        f"{x.dtype}: the compiled step has "
                        f"{tuple(buf.shape)} and {buf.dtype}")
                buf.copy_(x)

    def _load_actions(self, env, actions):
        """Copies `actions` into the action buffer, which has the shape of
        the action space's `action_shape_dtype` (else of the first actions)
        and the dtype actions enter a step in (`Environment._action_dtype`):
        an action of another dtype is cast (a host array on the host,
        before its copy)."""
        if not isinstance(actions, torch.Tensor):
            actions = torch.from_numpy(np.asarray(actions))
            actions = actions.to(env._action_dtype(actions.dtype))
            if self.device.type == "cuda":
                # Pinned, so the copy is queued and not waited for; the
                # host allocator keeps the block until the copy has run.
                actions = actions.pin_memory()
        if self._actions is None:
            spec = getattr(env.action_space, "action_shape_dtype", None)
            shape = tuple(actions.shape[1:] if spec is None else spec[0])
            self._actions = torch.empty(
                (self.lanes,) + shape, dtype=env._action_dtype(actions.dtype),
                device=self.device)
        if actions.shape != self._actions.shape:
            raise ValueError(
                f"actions of shape {tuple(actions.shape)}: the compiled "
                f"step has {tuple(self._actions.shape)}")
        self._actions.copy_(actions, non_blocking=True)

    def _load_keys(self, keys: torch.Tensor):
        if self._keys is None:
            self._keys = torch.empty((self.lanes, 2), dtype=torch.int32,
                                     device=self.device)
        if tuple(keys.shape) != (self.lanes, 2):
            raise ValueError(f"lane keys of shape {tuple(keys.shape)}: the "
                             f"compiled reset has ({self.lanes}, 2)")
        self._keys.copy_(keys, non_blocking=True)

    # The calls.
    def reset(self, env, keys: torch.Tensor):
        """Fresh scenes in every lane from lane keys `keys` int32[lanes,
        2]: (state, FIRST TimeStep), the buffers."""
        with profiling.annotate("compiled.reset"):
            self._load_keys(keys)
            self._launch(env, "reset")
        return self.state, self.timestep

    def step(self, env, state: EnvState, actions):
        """One step of every lane from `state` with `actions`: (state,
        TimeStep), the buffers; `state` is overwritten where it is the
        state buffers."""
        with profiling.annotate("compiled.step"):
            self._load_state(state)
            self._load_actions(env, actions)
            self._launch(env, "step")
        return self.state, self.timestep

    def observe(self, env, state: EnvState):
        """The renderers' observation of `state` (a buffer)."""
        self._load_state(state)
        self._launch(env, "observe")
        return self._obs

    @property
    def pending(self) -> Optional[torch.Tensor]:
        """The last launch's rejection flag (bool[] on the device), or None
        where that launch cannot have set it."""
        if not _may_pend(self._programs[self._last]):
            return None
        return self._pending

    def rerun(self, env):
        """The last launch again, eagerly with host-checked rejection, from
        the state (or keys) it started from: (state, TimeStep)."""
        name = self._last
        self.reruns += 1
        if name == "step":
            _copy(self.state, self._start)
        self._programs[name].run(
            1, functools.partial(getattr(self, "_" + name), env),
            defer=False)
        return self.state, self.timestep

    def _launch(self, env, name: str):
        body = functools.partial(getattr(self, "_" + name), env)
        if name not in self._programs:
            # A capture's warm-up runs the body: keep the state as it was.
            kept = (self.state.clone()
                    if self.use_graph and self.state is not None else None)
            self._programs[name] = StepGraph(body, self._pending,
                                             self.use_graph,
                                             name="compiled." + name)
            if kept is not None:
                _copy(self.state, kept)
        self._last = name
        with profiling.annotate("compiled.replay", device=True):
            self._programs[name].run(1, body)


class BatchedEnvironment:
    """An Environment stepped over a fixed number of lanes, its reset and
    step replayed as CUDA graphs: the counterpart of the JAX package's
    `BatchedEnvironment` (jit + vmap of an Environment).

    Args:
      env: the Environment (on this rank's device under a mesh).
      num_envs: global lanes; must divide by the mesh size. Each rank steps
        its contiguous `num_envs / mesh.size` of them.
      mesh: the 1-D 'envs' mesh (`parallel.mesh.env_mesh()`), the
        counterpart of JAX's `sharding`; None steps every lane here. No
        collective runs in the step.
      use_graph: replay the reset and the step from CUDA graphs, each
        captured at its first call (`Compiled`). The default is True on a
        CUDA env and False on a CPU env; True on a CPU env raises. A capture
        that fails raises: nothing falls back to the eager step.

    `step(state, actions)` donates `state`, as JAX's `donate_argnums=(0,)`
    does: the returned state is the step's own state buffers, which the
    next reset or step overwrites, so a state passed to `step` must not be
    read afterwards (clone what must be kept). Passing the state that the
    last call returned copies nothing. The returned TimeStep is the
    caller's. Where a scene sampler rejects (a `Selection`), the step reads
    the device once (the deferred rejection flag); JAX's `lax.while_loop`
    reads nothing.

    Keys: `reset(key)` gives the global lanes `split(key, num_envs)`, as
    JAX's `reset(key)` does, each rank taking its slice, and
    `sample_actions(key)` draws lane i's action from lane i of
    `split(key, num_envs)`: lanes, scenes and actions are the same on any
    mesh. Without a key, `sample_actions()` splits the action key
    `action_key`, which `reset(key)` starts at `fold_in(key, 1)`.
    """

    def __init__(self, env: Environment, num_envs: int, mesh=None,
                 use_graph: Optional[bool] = None):
        self.env = env
        self.num_envs = int(num_envs)
        self.mesh = mesh
        size, self.rank, device = ((1, 0, env.device) if mesh is None
                                   else (mesh.size, mesh.rank, mesh.device))
        if self.num_envs % size:
            raise ValueError(f"num_envs={num_envs} must divide the mesh "
                             f"size {size}.")
        if not device_lib.same_device(env.device, device):
            raise ValueError(f"the env runs on {env.device}, this rank of "
                             f"the mesh on {device}")
        self.local_envs = self.num_envs // size
        self._compiled = Compiled(env.device, self.local_envs, use_graph)
        self.use_graph = self._compiled.use_graph
        # The key `sample_actions()` splits (int32[2]), set by `reset`.
        self.action_key = env.root_key()

    @property
    def reruns(self) -> int:
        """Resets and steps run again because rejection was pending."""
        return self._compiled.reruns

    def _local_keys(self, key: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `split(key, num_envs)`."""
        return lane_random.split(key, self.local_envs,
                                 start=self.rank * self.local_envs)

    def reset(self, key=None):
        """Fresh scenes in this rank's lanes: (state, FIRST TimeStep).

        `key` (a key int32[2] or an int seed; None is the env's `seed`)
        splits over the global lanes; the action key restarts at
        `fold_in(key, 1)`."""
        key = self.env.root_key(key)
        self._compiled.reset(self.env, self._local_keys(key))
        self.action_key = lane_random.fold_in(key, 1)
        return self._finish()

    def step(self, state: EnvState, actions):
        """One step of this rank's lanes: (state, TimeStep); see the class
        docstring on donation."""
        self._compiled.step(self.env, state, actions)
        return self._finish()

    def _finish(self):
        c = self._compiled
        if c.pending is not None and bool(c.pending):
            c.rerun(self.env)
        return c.state, _map_timestep(torch.clone, c.timestep)

    def sample_actions(self, key=None):
        """Random actions of this rank's lanes, lane i's from lane i of
        `split(key, num_envs)`. Without `key`, the action key splits in
        two: the first carries on, the second is used."""
        if key is None:
            keys = lane_random.split(self.action_key, 2)
            self.action_key, key = keys[0], keys[1]
        return self.env.sample_action(
            self._local_keys(self.env.root_key(key)))

    def observation_spec(self):
        return self.env.observation_spec()

    def action_spec(self):
        return self.env.action_spec()
