"""The `adapter` loop: one agent on one environment, as a dm_env agent or a
demo player steps it.

`spriteworld_torch.adapters.dm_env_adapter.Environment` of the
configuration, one agent in a closed loop: `reset()`, then `step()` with an
action drawn from the seed on the host (NumPy, uniform over the action
space), the next call only after the last returned, and `reset()` after
each LAST. `dm_env` comes from `perfbench/dm_env_stand_in.py` where it is
not installed. Parameters: `warmup_steps`; `check.episodes`, the episodes
the comparison samples (the first and last among them); `trace.steps`,
the profiled slice.

The comparison (`check`): each sampled episode from its reset's key, which
the reference derives from the seed, with the recorded actions: the
observation at the reset and every step's observation, reward and step
type; after the last episode, the state.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import List

import numpy as np
import torch

from perfbench import check as cmp
from perfbench import traffic
from perfbench.reference import engine, threefry


def reset_keys(seed: int, resets: int) -> np.ndarray:
    """uint32[resets + 1, 2]: the lane key of the scene drawn at an
    adapter's construction (row 0) and of each of its resets (row r). The
    adapter carries k_0 = key(seed) and splits it once for the scene drawn
    at construction and once a reset: row r is T(k_r, 1), and k_{r+1} =
    T(k_r, 0)."""
    k = threefry.key(seed)
    out = []
    for _ in range(resets + 1):
        out.append(threefry.blocks(k, 1))
        k = threefry.blocks(k, 0)
    return np.stack(out)


def simulate(env: engine.Env, lane_key, actions, observation: str):
    """(first observation, step types [n], rewards [n], observations [n,
    ...], end state) of an episode from a reset's lane key and its
    actions."""
    state = env.reset(lane_key[None])
    first = env.observe(state, observation)
    sts, rws, obs = [], [], []
    for a in actions:
        state, st, rw = env.step(state, np.asarray(a, np.float32)[None])
        sts.append(st[0])
        rws.append(rw[0])
        obs.append(env.observe(state, observation))
    return (first, np.array(sts, np.int32), np.array(rws, np.float32),
            cmp.stack(obs) if obs else None, state)


def check(rec: dict, reference, observation: str,
          control: bool = False) -> cmp.Tally:
    """Compares a single env's records (`Loop.records`) with the reference
    module's Env; with `control`, the reference in bfloat16 takes the
    program's place."""
    want_env = reference.build("float32")
    got_env = reference.build("bfloat16") if control else None
    tally = cmp.Tally()
    episodes = rec["episodes"]
    keys = reset_keys(rec["seed"], max(e["reset"] for e in episodes))
    for i in rec["checked"]:
        ep = episodes[i]
        n = len(ep["actions"])
        before = want_env.rng.blocks
        w = simulate(want_env, keys[ep["reset"]], ep["actions"],
                     observation)
        tally.blocks += want_env.rng.blocks - before
        tally.lane_steps += n
        if control:
            g = simulate(got_env, keys[ep["reset"]], ep["actions"],
                         observation)
            g = g[:4] + (engine.state_dict(g[4]),)
        else:
            g = (ep["first"], ep["step_type"], ep["reward"],
                 cmp.stack(ep["observation"]) if n else None, rec["final"])
        tally.answer(cmp.observation_off(tally, g[0], w[0], 1))
        if n:
            tally.answer(tally.off("timestep_values_off", g[1], w[1])
                         | tally.off("timestep_values_off", g[2], w[2])
                         | cmp.observation_off(tally, g[3], w[3], 1))
        if i == len(episodes) - 1:
            tally.answer(cmp.state_off(tally, g[4], w[4]))
    return tally


class Loop:
    """The `adapter` loop."""

    check = staticmethod(check)

    def __init__(self, mix: dict, env_kwargs: dict, observation: str,
                 device, seed: int, tracer):
        self.mix, self.env_kwargs = mix, env_kwargs
        self.observation = observation
        self.device, self.seed, self.tracer = device, int(seed), tracer
        self._actions = traffic.seeded(self.seed, 0)
        self._rng = traffic.seeded(self.seed, 1)
        self._stack = contextlib.ExitStack()
        self.episodes: List[dict] = []
        self.times: List[float] = []
        self.resets = 0
        self.profiled = 0
        self.stand_in = False

    def setup(self, seconds: float) -> dict:
        """Build the adapter (under the dm_env stand-in where `dm_env` is
        missing), reset, and warm up with `warmup_steps` steps; `seconds`
        is not needed (samples stay on the host)."""
        del seconds
        from perfbench.dm_env_stand_in import dm_env_stand_in

        clock, stages = time.perf_counter, {}
        t = clock()
        self.stand_in = not self._stack.enter_context(dm_env_stand_in())
        import dm_env
        from spriteworld_torch.adapters import dm_env_adapter

        self._last = dm_env.StepType.LAST
        self.env = dm_env_adapter.Environment(
            **self.env_kwargs, seed=self.seed, device=self.device)
        stages["env_s"] = clock() - t
        t = clock()
        self._reset()
        for _ in range(int(self.mix["warmup_steps"])):
            if self._step(self._action()).step_type == self._last:
                self._reset()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stages["warmup_s"] = clock() - t
        return stages

    def _action(self) -> np.ndarray:
        return self._actions.random(4, dtype=np.float32)

    def _reset(self):
        with self.tracer.span("reset"):
            ts = self.env.reset()
        self.resets += 1
        return ts

    def _step(self, action):
        with self.tracer.span("step"):
            return self.env.step(action)

    def window(self, seconds: float, trace: bool) -> dict:
        """reset(), then step() and reset() after each LAST, until
        `seconds` have passed; with `trace`, `trace.steps` more steps
        follow under the profiler."""
        clock = time.perf_counter
        t0 = clock()
        ep = self._episode(self._reset())
        while True:
            ts = self._advance(ep)
            done = clock() - t0 >= seconds
            if ts.step_type == self._last:
                self.episodes.append(ep)
                if done:
                    break
                ep = self._episode(self._reset())
            elif done:
                self.episodes.append(ep)
                break
        elapsed, n = clock() - t0, len(self.times)
        ms = [t * 1e3 for t in self.times]
        info = {"steps": n, "episodes": len(self.episodes),
                "step_ms_p50": statistics.median(ms),
                "step_ms_p99": traffic.percentile(ms, 0.99),
                "step_ms_min": min(ms), "step_ms_max": max(ms)}
        if trace:
            self.profiled = int(self.mix["trace"]["steps"])
            if ts.step_type != self._last:
                self.episodes.pop()
            else:
                ep = self._episode(self._reset())
            self.tracer.start()
            for i in range(self.profiled):
                if self._advance(ep).step_type == self._last:
                    self.episodes.append(ep)
                    if i + 1 < self.profiled:
                        ep = self._episode(self._reset())
            self.tracer.stop()
            if not self.episodes or self.episodes[-1] is not ep:
                self.episodes.append(ep)
        info.update(reruns=self.env._compiled.reruns)
        return {"attempted": len(self.times), "elapsed": elapsed,
                "metrics": {"step_ms": elapsed * 1e3 / n}, "info": info}

    def _advance(self, ep: dict):
        """One step of the agent: draw an action, step, keep the samples;
        returns the TimeStep."""
        with self.tracer.span("agent"):
            action = self._action()
        t1 = time.perf_counter()
        ts = self._step(action)
        self.times.append(time.perf_counter() - t1)
        with self.tracer.span("keep samples"):
            ep["actions"].append(action)
            ep["step_type"].append(int(ts.step_type))
            ep["reward"].append(np.float32(ts.reward))
            ep["observation"].append(ts.observation[self.observation])
        return ts

    def _episode(self, ts) -> dict:
        return {"reset": self.resets,
                "first": ts.observation[self.observation],
                "actions": [], "step_type": [], "reward": [],
                "observation": []}

    def records(self) -> dict:
        final = traffic.host({k: getattr(self.env._state, f)
                              for k, f in traffic.STATE_FIELDS.items()})
        episodes = []
        for ep in self.episodes:
            n = len(ep["actions"])
            episodes.append({
                "reset": ep["reset"], "first": traffic.host(ep["first"]),
                "actions": np.array(ep["actions"], np.float32).reshape(n, 4),
                "step_type": np.array(ep["step_type"], np.int32),
                "reward": np.array(ep["reward"], np.float32),
                "observation": traffic.host(ep["observation"])})
        return {"seed": self.seed, "episodes": episodes, "final": final,
                "checked": cmp.sample_indices(
                    self._rng, len(episodes), self.mix["check"]["episodes"])}

    def free(self):
        self.__dict__.pop("env", None)
        self._stack.close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def trace_context(self) -> dict:
        untraced = self.times[:len(self.times) - self.profiled]
        return {"calls": self.profiled, "steps": self.profiled, "lanes": 1,
                "host_step_ms": [t * 1e3 for t in untraced]}
