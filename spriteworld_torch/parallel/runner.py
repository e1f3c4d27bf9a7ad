"""Batched runner: rollout chunks replayed as a CUDA graph, metrics on the
device.

Counterpart of `spriteworld_tpu/parallel/runner.py`. There a whole rollout
chunk is one jitted `lax.scan`, so per-step host dispatch disappears. Here
`ShardedRunner` captures one step of B lockstep env lanes — the policy's
actions, `Environment.step_batch` (transition, auto-reset, render) and the
metric updates — in a `torch.cuda.CUDAGraph` and replays it `num_steps`
times: the host launches one graph a step instead of the several hundred
kernels and operators the step is made of, and reads the device once a
chunk. The step makes no host sync (`core/environment.py`), which is what
lets it be captured. A CPU environment, which the caller asked for, runs the
same step eagerly; so does `use_graph=False` on the card.

Metrics mirror what the reference logs per episode (example_run_loop.py:
79-80: success + nanmean reward), lifted to batched aggregates: completed
episodes, successes at termination, summed returns (NaN rewards excluded the
way np.nanmean excludes them).

Randomness: the JAX runner threads a key through every call; here every
draw (actions, fresh scenes, action noise) comes from the environment's
`torch.Generator`, which the graph registers, so each replay draws anew and
a replay draws exactly what the eager step would from the same generator
state.

Rejection sampling: inside a chunk, a rejection node that still has pending
elements after its first `distributions.REJECTION_ROUNDS` proposals sets a
flag on the device instead of asking the host (`defer_rejection`). The
runner reads the flag with the metrics at the chunk boundary and, where it
is set, runs the chunk again eagerly from its start state and generator
state with host-checked rejection, which continues the same draws: the
result is the JAX package's per-element do-while up to MAX_REJECTION_TRIES.

Devices: the runner runs on the environment's device. Under a mesh
(`parallel/mesh.py`) of several ranks, each rank's runner steps its
contiguous slice of the global lanes (`num_envs / mesh.size`) on the rank's
device, in its own captured graph; at the chunk boundary the counts (as
int64: a global chunk can pass 2**31 where no rank's does) and the float32
sums go through `all_reduce(SUM)` outside the graph, on the same stream,
before the chunk's one host read, so every rank returns the global metrics.

Randomness under a mesh, the port's one deliberate difference from the JAX
runner: JAX keys every lane from the key, so its rollout is the same
whatever the mesh shape. Here each rank draws from its own env's generator,
seeded by `reset(seed)` with `rank_seed(seed, rank)`; rank 0 takes `seed`
itself, so rank 0 of a mesh of one is exactly the runner without a mesh,
and a mesh of n ranks equals n runners without a mesh, each of
`num_envs / n` lanes seeded with its rank's seed. Another mesh shape draws
other scenes and actions (ROADMAP, "Randomness").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from spriteworld_torch.core.environment import (  # noqa: F401
    Environment, rank_seed)
from spriteworld_torch.core.state import STATE_FIELDS, EnvState, TimeStep
from spriteworld_torch.core.step_graph import (  # noqa: F401
    StepGraph, use_graph_for)
from spriteworld_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class Metrics:
    """Rollout aggregates, on the host.

    Inside a chunk the counters are i32 on the device, and a chunk is
    guarded to stay below i32 range; `ShardedRunner.rollout` hands them out
    as Python ints, so accumulation across chunks is arbitrary-precision.
    The sums are the device's float32 values.
    """

    steps: int  # total env steps taken
    episodes: int  # episodes completed (LAST timesteps)
    successes: int  # episodes that ended in task success
    return_sum: float  # sum of completed-episode returns
    reward_sum: float  # nan-excluded sum of all step rewards

    @classmethod
    def zero(cls) -> "Metrics":
        return cls(steps=0, episodes=0, successes=0, return_sum=0.0,
                   reward_sum=0.0)

    def __add__(self, other: "Metrics") -> "Metrics":
        return Metrics(*(a + b for a, b in zip(dataclasses.astuple(self),
                                               dataclasses.astuple(other))))

    @property
    def success_rate(self) -> float:
        return self.successes / max(self.episodes, 1)

    @property
    def mean_return(self) -> float:
        return self.return_sum / max(self.episodes, 1)


@dataclasses.dataclass
class EvalStats:
    """Per-episode evaluation aggregates (see ShardedRunner.evaluate)."""

    episodes: int
    mean_return: float
    std_return: float
    ci95_return: float
    success_rate: float


def _map(fn, tree):
    """`fn` over the tensors of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _to_host(t: torch.Tensor) -> list:
    """t.tolist(): the chunk's one intended host sync, exempt from
    `torch.cuda.set_sync_debug_mode`, which then watches the steps alone."""
    if not t.is_cuda:
        return t.tolist()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@dataclasses.dataclass
class _Carry:
    """What one step reads and writes in place: the lanes' state, the
    per-lane return accumulator, the metric accumulators (i32 episodes and
    successes, f32 return and reward sums), the rejection flag, and with
    stacked timesteps the step index and the [T, B, ...] buffers."""

    state: EnvState
    ret_acc: torch.Tensor
    counts: torch.Tensor
    sums: torch.Tensor
    pending: torch.Tensor
    t: torch.Tensor
    stacked: Optional[TimeStep] = None

    @classmethod
    def like(cls, state: EnvState, ret_acc: torch.Tensor) -> "_Carry":
        dev = ret_acc.device
        return cls(
            state=state.clone(),
            ret_acc=ret_acc.clone(),
            counts=torch.zeros(2, dtype=torch.int32, device=dev),
            sums=torch.zeros(2, dtype=torch.float32, device=dev),
            pending=torch.zeros((), dtype=torch.bool, device=dev),
            t=torch.zeros(1, dtype=torch.int64, device=dev))

    def load(self, state: EnvState, ret_acc: torch.Tensor):
        """Start a chunk from `state` and `ret_acc` (device copies only)."""
        for n in STATE_FIELDS:
            getattr(self.state, n).copy_(getattr(state, n))
        self.ret_acc.copy_(ret_acc)
        for x in (self.counts, self.sums, self.pending, self.t):
            x.zero_()


class ShardedRunner:
    """Steps a batch of env lanes in lockstep chunks.

    Args:
      env: the Environment, on this rank's device (`mesh.device`).
      num_envs: global lanes; must divide by the mesh size. Each rank steps
        `num_envs / mesh.size` of them.
      mesh: the 1-D 'envs' mesh (`parallel.mesh.env_mesh()`); None is the
        mesh of one on `env.device`.
      policy: optional `(generator, state) -> actions` batch policy; it must
        draw from `generator` (the env's) and make no host sync, since it is
        captured with the step. Defaults to the env's uniform random action
        sampler (the reference's RandomAgent, example_run_loop.py:46-59).
      use_graph: replay each chunk's steps as a captured CUDA graph. The
        default is True on a CUDA env and False on a CPU env; True on a CPU
        env raises. A capture that fails raises: nothing falls back to the
        eager step.

    Under a mesh of several ranks, seed `reset` with an int (each rank
    then seeds `rank_seed(seed, rank)`), or build each rank's env with its
    own seed: ranks whose generators start equal draw equal lanes.
    """

    def __init__(self,
                 env: Environment,
                 num_envs: int,
                 mesh: Optional[mesh_lib.EnvMesh] = None,
                 policy: Optional[Callable] = None,
                 use_graph: Optional[bool] = None):
        self.env = env
        self.num_envs = int(num_envs)
        self.mesh = mesh if mesh is not None \
            else mesh_lib.EnvMesh.single(env.device)
        if self.num_envs % self.mesh.size:
            raise ValueError(
                f"num_envs={num_envs} must divide the mesh size "
                f"{self.mesh.size}.")
        if not mesh_lib.same_device(env.device, self.mesh.device):
            raise ValueError(f"the env runs on {env.device}, this rank of "
                             f"the mesh on {self.mesh.device}")
        self.local_envs = self.num_envs // self.mesh.size
        self._shard = mesh_lib.env_sharding(self.mesh)
        self._repl = mesh_lib.replicated_sharding(self.mesh)
        self._policy = policy
        self.use_graph = use_graph_for(env.device, use_graph)
        self._programs: Dict[tuple, tuple] = {}
        self._ret_acc = None
        # Chunks run again because a rejection node still had pending
        # elements after its first rounds (on any rank).
        self.reruns = 0

    # ------------------------------------------------------------------ #
    def reset(self, seed=None):
        """Fresh scenes in this rank's lanes: (state, FIRST TimeStep).

        `seed` re-seeds the env's generator (an int; rank r of a mesh takes
        `rank_seed(seed, r)`) or restores it (a state from
        `env.generator.get_state()`); None draws on from where it is. The
        per-lane return accumulator restarts from zero."""
        if isinstance(seed, int):
            self.env.generator.manual_seed(rank_seed(seed, self.mesh.rank))
        elif seed is not None:
            self.env.generator.set_state(seed)
        state, ts = self.env.reset_batch(self.local_envs)
        self._ret_acc = torch.zeros(self.local_envs, dtype=torch.float32,
                                    device=self.env.device)
        return state, ts

    def _actions(self, state):
        if self._policy is not None:
            return self._policy(self.env.generator, state)
        return self.env.sample_action(self.local_envs)

    def _step(self, carry: _Carry, num_steps: int, with_returns: bool,
              obs_keys):
        """One step on `carry`, in place (inside `StepGraph.run`)."""
        state, ts = self.env.step_batch(carry.state,
                                        self._actions(carry.state))

        last = ts.last()
        reward = torch.nan_to_num(ts.reward)  # nanmean-style exclusion
        ret_acc = carry.ret_acc + reward
        ep_return = torch.where(last, ret_acc, 0.0)
        carry.ret_acc.copy_(torch.where(last, 0.0, ret_acc))
        # Success is observed through the renderer-as-metrics pattern
        # (reference example_run_loop.py:67); absent renderer -> False.
        success = ts.observation.get("success", torch.zeros_like(last))
        carry.counts.add_(torch.stack([
            last.sum(dtype=torch.int32),
            (last & success).sum(dtype=torch.int32)]))
        carry.sums.add_(torch.stack([
            ep_return.sum(dtype=torch.float32),
            reward.sum(dtype=torch.float32)]))
        for n in STATE_FIELDS:
            getattr(carry.state, n).copy_(getattr(state, n))
        if not with_returns:
            return

        obs = ts.observation
        if obs_keys is not None:
            obs = {k: v for k, v in obs.items() if k in obs_keys}
        # Leaves with more than one per-lane dim are flattened to [B, -1],
        # as the JAX runner returns them.
        obs = _map(lambda x: x.reshape(x.shape[0], -1) if x.dim() > 2
                   else x, obs)
        ts = TimeStep(step_type=ts.step_type, reward=ts.reward,
                      discount=ts.discount, observation=obs)
        if carry.stacked is None:
            carry.stacked = TimeStep(*(
                _map(lambda x: torch.empty((num_steps,) + tuple(x.shape),
                                           dtype=x.dtype, device=x.device),
                     getattr(ts, f.name))
                for f in dataclasses.fields(TimeStep)))
        for f in dataclasses.fields(TimeStep):
            for buf, x in zip(_leaves(getattr(carry.stacked, f.name)),
                              _leaves(getattr(ts, f.name))):
                buf.index_copy_(0, carry.t, x.unsqueeze(0))
        carry.t.add_(1)

    def _program(self, sig, state: EnvState, use_graph: bool):
        """(carry, StepGraph) of signature `sig`, built at first use."""
        key = sig + (use_graph,)
        if key not in self._programs:
            carry = _Carry.like(state, self.episode_returns)
            self._programs[key] = (carry, StepGraph(
                lambda: self._step(carry, *sig), self.env.generator,
                carry.pending, use_graph))
        return self._programs[key]

    def _chunk(self, carry, program, sig, state, ret_acc, defer):
        """Run one chunk on `carry`; returns the global values read at the
        boundary: [episodes, successes, pending, return_sum, reward_sum]."""
        carry.load(state, ret_acc)
        program.run(sig[0], lambda: self._step(carry, *sig), defer=defer)
        counts = torch.cat([carry.counts.to(torch.int64),
                            carry.pending.to(torch.int64)[None]])
        sums = carry.sums.clone()
        self._repl.all_reduce(counts)
        self._repl.all_reduce(sums)
        return _to_host(torch.cat([counts.double(), sums.double()]))

    # ------------------------------------------------------------------ #
    @property
    def episode_returns(self) -> torch.Tensor:
        """Per-lane in-flight episode return accumulator of this rank's
        lanes (f32[num_envs / mesh.size]).

        Checkpoint this alongside the EnvState and the env's generator and
        assign it back after `restore_state` — otherwise returns of
        episodes already in flight at save time restart from zero (see
        parallel/checkpoint.py)."""
        if self._ret_acc is None:
            self._ret_acc = torch.zeros(self.local_envs, dtype=torch.float32,
                                        device=self.env.device)
        return self._ret_acc

    @episode_returns.setter
    def episode_returns(self, value):
        value = torch.as_tensor(value, dtype=torch.float32,
                                device=self.env.device)
        if tuple(value.shape) != (self.local_envs,):
            raise ValueError(
                f"episode_returns must have shape ({self.local_envs},), got "
                f"{tuple(value.shape)}")
        self._ret_acc = value

    def rollout(self, state: EnvState, num_steps: int,
                return_timesteps=False, episode_returns=None,
                timestep_obs=None):
        """Run `num_steps` lockstep steps; returns (state, Metrics[, ts]).

        `state` and the returned state hold this rank's lanes; the Metrics
        are global (every rank returns the same). On a CUDA env with
        `use_graph`, the steps replay a graph captured at the first call of
        each (num_steps, return_timesteps, timestep_obs).
        `return_timesteps=True` also stacks this rank's TimeSteps as
        [T, B_local, ...] (use small chunks: the trace is kept on the
        device); observation leaves with more than one per-lane dim come
        back flattened to [T, B_local, -1], as the JAX runner returns them
        (an image is [T, B_local, H*W*3]). `timestep_obs` restricts the
        stacked observations to the given top-level keys.
        `episode_returns` seeds the per-lane in-flight return accumulator
        (e.g. restored from a checkpoint); by default the accumulator
        carried since the last `reset()` is used. The input state is left
        as it is.
        """
        if episode_returns is not None:
            self.episode_returns = episode_returns
        if int(num_steps) < 1:
            raise ValueError(f"num_steps must be positive, got {num_steps}")
        if int(num_steps) * self.num_envs >= 2**31:
            raise ValueError(
                f"A single chunk of {num_steps} steps x {self.num_envs} "
                "envs would overflow the on-device i32 step counter; split "
                "into smaller chunks (host-side accumulation is unbounded).")
        if timestep_obs is not None:
            timestep_obs = tuple(timestep_obs)
        sig = (int(num_steps), bool(return_timesteps), timestep_obs)
        carry, program = self._program(sig, state, self.use_graph)
        ret_acc = self.episode_returns
        gen_start = self.env.generator.get_state()
        host = self._chunk(carry, program, sig, state, ret_acc, defer=True)
        if host[2]:
            # A rejection node ran past its first rounds on some rank:
            # every rank runs the same chunk again, eagerly, with
            # host-checked rejection from the same draws.
            self.reruns += 1
            self.env.generator.set_state(gen_start)
            carry, program = self._program(sig, state, use_graph=False)
            host = self._chunk(carry, program, sig, state, ret_acc,
                               defer=False)
        new_state = carry.state.clone()
        self._ret_acc = carry.ret_acc.clone()
        metrics = Metrics(steps=int(num_steps) * self.num_envs,
                          episodes=int(host[0]), successes=int(host[1]),
                          return_sum=host[3], reward_sum=host[4])
        if return_timesteps:
            return new_state, metrics, TimeStep(*(
                _map(torch.clone, getattr(carry.stacked, f.name))
                for f in dataclasses.fields(TimeStep)))
        return new_state, metrics

    # ------------------------------------------------------------------ #
    def evaluate(self, num_episodes: int, chunk_steps: int = 128,
                 max_chunks: int = 1000) -> EvalStats:
        """Policy evaluation: run until >= `num_episodes` episodes finish.

        The batched replacement for the reference's per-episode eval loop
        (example_run_loop.py:72-80): all lanes run in lockstep chunks from a
        fresh reset (drawn from the env's generator); per-episode returns
        and successes are recovered exactly on the host from the stacked
        timesteps (NaN rewards excluded the way np.nanmean does). Under a
        mesh the stacked rewards, step types and successes are gathered
        into global lane order first, so every rank computes the same
        stats. Returns `EvalStats` with mean/std/95%-CI of episode returns
        and the success rate.

        Episodes still in flight when the target is reached are discarded.
        Within the cutoff chunk, `num_episodes` is hit mid-chunk and the
        earliest-finishing episodes of that chunk are kept — a mild bias
        toward shorter episodes at the margin (bounded by one chunk's worth
        of episodes; shrink `chunk_steps` to shrink it). The in-flight
        episode-return accumulator carried since the caller's last
        `reset()` is saved and restored around the evaluation.
        """
        saved_ret_acc = self._ret_acc
        try:
            state, _ = self.reset()
            acc = np.zeros((self.num_envs,), np.float64)
            returns = []
            successes = []
            for _ in range(max_chunks):
                if len(returns) >= num_episodes:
                    break
                state, _, tss = self.rollout(
                    state, chunk_steps, return_timesteps=True,
                    timestep_obs=("success",))
                last = tss.last()
                succ = tss.observation.get("success", torch.zeros_like(last))
                rew, last, succ = (x.cpu().numpy() for x in self._shard.gather(
                    (tss.reward, last, succ), axis=1))
                rew = np.nan_to_num(rew.astype(np.float64))
                for t in range(rew.shape[0]):
                    acc += rew[t]
                    done = last[t]
                    if done.any():
                        returns.extend(acc[done].tolist())
                        successes.extend(succ[t][done].tolist())
                        acc[done] = 0.0
            if len(returns) < num_episodes:
                raise RuntimeError(
                    f"evaluate() hit max_chunks={max_chunks} with only "
                    f"{len(returns)}/{num_episodes} episodes; is the env "
                    "terminating?")
        finally:
            self._ret_acc = saved_ret_acc
        returns_arr = np.asarray(returns[:num_episodes], np.float64)
        succ_arr = np.asarray(successes[:num_episodes], np.float64)
        n = len(returns_arr)
        std = float(returns_arr.std(ddof=1)) if n > 1 else 0.0
        sem = std / np.sqrt(n) if n > 1 else 0.0
        return EvalStats(
            episodes=n,
            mean_return=float(returns_arr.mean()),
            std_return=std,
            ci95_return=1.96 * float(sem),
            success_rate=float(succ_arr.mean()),
        )
