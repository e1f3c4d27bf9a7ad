"""The environment core: batched reset/step with per-lane auto-reset.

Counterpart of `spriteworld_tpu/core/environment.py`, batch-native. The
`Environment` holds static configuration (task, action space, renderers,
scene generator, episode limits), the device and the `torch.Generator` that
all sampling draws from; dynamic state lives in an :class:`EnvState` with a
leading lane axis.

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
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from spriteworld_torch.core.state import (STATE_FIELDS, EnvState, StepType,
                                          TimeStep)
from spriteworld_torch.core.tasks import task_valid
from spriteworld_torch.ops import geometry
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling


class Environment:
    """Static environment configuration + batched transition functions.

    The constructor mirrors the reference Environment.__init__ so config
    dicts translate one-to-one, plus `device` (default "cuda") and `seed`
    for the environment's generator.
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
        self._action_space = action_space
        self._renderers = dict(renderers)
        self._init_sprites = init_sprites
        self._keep_in_frame = bool(keep_in_frame)
        self._max_episode_length = int(max_episode_length)
        self._metadata = metadata
        self.device = device_lib.resolve(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
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

    def observation_batch(self, factors, num_sprites, success):
        return {name: r.render(factors, num_sprites, success)
                for name, r in self._renderers.items()}

    def _fresh(self, batch: int, reset_next: bool) -> EnvState:
        factors, num, ok = self._init_sprites.sample_with_status(
            self.generator, batch)
        return EnvState(
            factors=factors,
            num_sprites=num,
            step_count=torch.zeros(batch, dtype=torch.int32,
                                   device=self.device),
            reset_next=torch.full((batch,), reset_next, dtype=torch.bool,
                                  device=self.device),
            sample_ok=ok,
            task_valid=task_valid(self._task, factors, num))

    def reset_batch(self, batch: int):
        """Sample B fresh scenes; returns (EnvState, FIRST TimeStep)."""
        state = self._fresh(batch, reset_next=False)
        success = self._task.success(state.factors, state.num_sprites)
        obs = self.observation_batch(
            state.factors, state.num_sprites, success)
        ts = TimeStep(
            step_type=torch.full((batch,), StepType.FIRST, dtype=torch.int32,
                                 device=self.device),
            reward=torch.zeros(batch, device=self.device),
            discount=torch.ones(batch, device=self.device),
            observation=obs)
        return state, ts

    def initial_state(self, batch: int) -> EnvState:
        """State of B freshly constructed reference Environments: sprites
        sampled, and the first step still resets (reset_next=True)."""
        return self._fresh(batch, reset_next=True)

    def step_batch(self, state: EnvState, actions: torch.Tensor):
        """One transition of every lane plus one render: (state, TimeStep).

        Lanes whose previous step was LAST take a fresh scene and emit FIRST
        (reward 0, discount 1) instead of stepping."""
        with profiling.annotate("spriteworld.transition"):
            factors, cost = self._action_space.step(
                actions, state.factors, state.num_sprites,
                self._keep_in_frame, self.generator)
            # Velocity integration for every sprite; dead slots carry zero
            # velocity so padding is unaffected.
            new_pos = factors[..., 0:2] + factors[..., 8:10]
            if self._keep_in_frame:
                new_pos = new_pos.clamp(0.0, 1.0)
            factors[..., 0:2] = new_pos
            num = state.num_sprites

            reward = cost + self._task.reward(factors, num)
            success = self._task.success(factors, num)
            oof = geometry.out_of_frame(factors, num)
            step_count = state.step_count + 1
            terminate = success | oof | (
                step_count >= self._max_episode_length)
            stepped = EnvState(
                factors=factors,
                num_sprites=num,
                step_count=step_count,
                reset_next=terminate,
                sample_ok=state.sample_ok,
                task_valid=task_valid(self._task, factors, num))

            # Lanes that ended last step start a new episode instead.
            reset = state.reset_next
            fresh = self._fresh(reset.shape[0], reset_next=False)

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

        with profiling.annotate("spriteworld.render"):
            success = self._task.success(new.factors, new.num_sprites)
            obs = self.observation_batch(new.factors, new.num_sprites,
                                         success)
        return new, TimeStep(step_type=step_type, reward=reward,
                             discount=discount, observation=obs)

    def sample_action(self, batch: int):
        return self._action_space.sample(self.generator, batch)


class BatchedEnvironment:
    """An Environment stepped over a fixed number of lanes."""

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = int(num_envs)

    def reset(self):
        return self.env.reset_batch(self.num_envs)

    def step(self, state, actions):
        return self.env.step_batch(state, actions)

    def sample_actions(self):
        return self.env.sample_action(self.num_envs)

    def observation_spec(self):
        return self.env.observation_spec()

    def action_spec(self):
        return self.env.action_spec()
