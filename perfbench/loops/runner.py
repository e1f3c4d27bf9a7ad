"""The `runner` loop: batched rollouts, as an RL trainer collects data.

`spriteworld_torch.parallel.ShardedRunner(env, lanes)` with its default
policy (the reference's RandomAgent, drawn from the runner's action key),
reset from the seed, and `rollout(state, steps_per_call,
return_timesteps=True)` called back to back by one caller, the stacked
timesteps left on the device as a learner would receive them. Parameters:
`lanes`, `steps_per_call`, `warmup_calls`; `check.lanes`, the lanes the
comparison samples, and `check.calls`, the calls it compares (the window's
first and last among them); `trace.calls`, the profiled slice.

Each call gathers the sampled lanes of its timesteps (a few MB) and keeps
them only where the call is to be compared, or is the last so far: the
calls to compare are drawn at set-up from the seed, over the calls that the
warm-up call's time says a window holds. The state and action key around a
call are the program's own tensors, held, not copied.

The comparison (`check`): the sampled lanes' reset from the seed (state
and observation); then, with nothing of the program's, the reference
steps those lanes from its own reset through the warm-up calls and the
window's first call, and compares that call's start, every step's
observation, reward and step type, and its end. Each later compared call
the reference steps from the program's state and action key at the call's
start (a whole window of 2048 lanes would outlast it).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import check as cmp
from perfbench import traffic
from perfbench.reference import engine, threefry


def simulate(env: engine.Env, state: engine.State, key, lanes, steps: int,
             observation: Optional[str]):
    """The reference's `steps` runner steps of `lanes` from a state and an
    action key: (step_type [T, L], reward [T, L], observation [T, L, ...]
    or None where `observation` is None, end state, end key)."""
    sts, rws, obs = [], [], []
    for _ in range(steps):
        go = ~state.reset_next
        key, lane_keys = env.action_keys(key, lanes[go])
        actions = np.zeros((len(lanes), 4), np.float32)
        actions[go] = env.random_actions(lane_keys)
        state, st, rw = env.step(state, actions)
        sts.append(st)
        rws.append(rw)
        if observation is not None:
            obs.append(env.observe(state, observation))
    return (np.stack(sts), np.stack(rws),
            cmp.stack(obs) if obs else None, state, key)


def _compare_call(tally, got: dict, want) -> None:
    """One call's timesteps and end (state and action key) against the
    reference's `simulate`."""
    tally.answer(tally.off("timestep_values_off", got["step_type"], want[0])
                 | tally.off("timestep_values_off", got["reward"], want[1])
                 | cmp.observation_off(tally, got["observation"], want[2],
                                       2))
    key_off = tally.off("state_values_off", cmp.words(got["end_key"]),
                        want[4]).any()
    tally.answer(cmp.state_off(tally, got["end"], want[3]) | key_off)


def check(rec: dict, reference, observation: str,
          control: bool = False) -> cmp.Tally:
    """Compares a rollout's records (`Loop.records`) with the reference
    module's Env; with `control`, the reference in bfloat16 takes the
    program's place."""
    want_env = reference.build("float32")
    got_env = reference.build("bfloat16") if control else None
    tally = cmp.Tally()
    lanes = np.asarray(rec["lanes"])
    steps, calls = rec["steps"], rec["calls"]
    root = threefry.key(rec["seed"])
    lane_keys = want_env.rng.block(root[None], lanes.astype(np.uint32))
    want = want_env.reset(lane_keys)
    if control:
        got = got_env.reset(lane_keys)
        got_state = engine.state_dict(got)
        got_obs = got_env.observe(got, observation)
    else:
        got_state = rec["reset"]["state"]
        got_obs = rec["reset"]["observation"]
    tally.answer(cmp.state_off(tally, got_state, want) | cmp.observation_off(
        tally, got_obs, want_env.observe(want, observation), 1))
    before, simulated = want_env.rng.blocks, 0
    # The action key starts at fold_in(key(seed), 1).
    key = threefry.blocks(root, 1)
    warm = rec["warmup_calls"] * steps
    want_start = simulate(want_env, want, key, lanes, warm, None)[3:]
    simulated += warm
    if control:
        got_start = simulate(got_env, got, key, lanes, warm, None)[3:]
    for c in rec["checked"]:
        call = calls[c]
        if c == 0:
            start, start_key = want_start
            g_start = (engine.state_dict(got_start[0]), got_start[1]) \
                if control else (call["start"], call["key"])
            key_off = tally.off("state_values_off", cmp.words(g_start[1]),
                                start_key).any()
            tally.answer(cmp.state_off(tally, g_start[0], start) | key_off)
        else:
            start = cmp.as_state(call["start"])
            start_key = cmp.words(call["key"])
        w = simulate(want_env, start, start_key, lanes, steps, observation)
        simulated += steps
        if control:
            if c == 0:
                g_from, g_key = got_start
            else:
                g_from, g_key = start.copy(), start_key
                g_from.factors = got_env.round(g_from.factors)
            g = simulate(got_env, g_from, g_key, lanes, steps, observation)
            got = {"step_type": g[0], "reward": g[1], "observation": g[2],
                   "end": engine.state_dict(g[3]), "end_key": g[4]}
        else:
            got = call
        _compare_call(tally, got, w)
    # Less the action key's split, two blocks a step for all lanes.
    tally.blocks += want_env.rng.blocks - before - 2 * simulated
    tally.lane_steps += simulated * len(lanes)
    return tally


class Loop:
    """The `runner` loop."""

    check = staticmethod(check)

    def __init__(self, mix: dict, env_kwargs: dict, observation: str,
                 device, seed: int, tracer):
        self.mix, self.env_kwargs = mix, env_kwargs
        self.observation = observation
        self.device, self.seed, self.tracer = device, int(seed), tracer
        self.lanes = int(mix["lanes"])
        self.steps = int(mix["steps_per_call"])
        self._rng = traffic.seeded(self.seed, 1)
        self.sample = np.asarray(cmp.sample_indices(
            self._rng, self.lanes, mix["check"]["lanes"]))
        self.kept: Dict[int, dict] = {}
        self.last: Optional[tuple] = None
        self.picks: set = set()
        self.n = 0
        self.profiled = 0

    def setup(self, seconds: float) -> dict:
        """Build the env and runner, reset from the seed, capture and warm
        up with `warmup_calls` calls (the window's own path, gathers
        included), and draw the calls to compare."""
        from spriteworld_torch.core import environment as env_lib
        from spriteworld_torch.parallel import ShardedRunner

        clock, stages = time.perf_counter, {}
        t = clock()
        self.env = env_lib.Environment(**self.env_kwargs, device=self.device)
        self.runner = ShardedRunner(self.env, self.lanes)
        self._idx = torch.as_tensor(self.sample, device=self.env.device)
        stages["env_s"] = clock() - t
        t = clock()
        state, ts = self.runner.reset(self.seed)
        self._reset = (traffic.lanes_of(state, self._idx),
                       traffic.gather(ts.observation[self.observation], 0,
                                      self._idx))
        del ts
        self._sync()
        stages["reset_s"] = clock() - t
        call_s = 0.0
        for i in range(int(self.mix["warmup_calls"])):
            t = clock()
            state = self._call(state)
            self._sync()
            call_s = clock() - t
            stages[f"warmup_call_{i}_s"] = call_s
        self.state, self.n, self.last = state, 0, None
        expected = max(int(seconds / max(call_s, 1e-6)), 1)
        middle = np.arange(1, expected)
        k = min(max(int(self.mix["check"]["calls"]) - 2, 0), len(middle))
        self.picks = {0} | {int(i) for i in
                            self._rng.choice(middle, k, replace=False)}
        return stages

    def _sync(self):
        if self.env.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, state):
        """One rollout call; gathers the sampled lanes' timesteps and keeps
        them, with the state and action key around the call, where the
        call is to be compared or is the last so far."""
        i, key = self.n, self.runner.action_key
        self.n += 1
        with self.tracer.span("rollout"):
            new, _, ts = self.runner.rollout(state, self.steps,
                                             return_timesteps=True)
        with self.tracer.span("keep samples"):
            rec = {"start": state, "key": key, "end": new,
                   "end_key": self.runner.action_key,
                   "step_type": ts.step_type.index_select(1, self._idx),
                   "reward": ts.reward.index_select(1, self._idx),
                   "observation": traffic.gather(
                       ts.observation[self.observation], 1, self._idx)}
            if i in self.picks:
                self.kept[i] = rec
            self.last = (i, rec)
        return new

    def window(self, seconds: float, trace: bool) -> dict:
        """Calls back to back until `seconds` have passed; with `trace`,
        `trace.calls` more calls follow under the profiler."""
        state = self.state
        t0 = time.perf_counter()
        while self.n == 0 or time.perf_counter() - t0 < seconds:
            state = self._call(state)
        self._sync()
        elapsed = time.perf_counter() - t0
        calls = self.n
        steps = self.lanes * self.steps * calls
        if trace:
            self.profiled = int(self.mix["trace"]["calls"])
            self.tracer.start()
            for _ in range(self.profiled):
                state = self._call(state)
            self.tracer.stop()
        self.state = state
        return {"attempted": self.lanes * self.steps * self.n,
                "elapsed": elapsed,
                "metrics": {"env_steps_per_s": steps / elapsed},
                "info": {"calls": calls, "env_steps": steps,
                         "reruns": self.runner.reruns}}

    def records(self) -> dict:
        calls = dict(self.kept)
        if self.last is not None:
            calls[self.last[0]] = self.last[1]
        out = {}
        for c, r in calls.items():
            out[c] = traffic.host({
                "start": traffic.lanes_of(r["start"], self._idx),
                "key": r["key"], "end": traffic.lanes_of(r["end"], self._idx),
                "end_key": r["end_key"], "step_type": r["step_type"],
                "reward": r["reward"], "observation": r["observation"]})
        return {"seed": self.seed, "lanes": self.sample, "steps": self.steps,
                "warmup_calls": int(self.mix["warmup_calls"]),
                "reset": traffic.host({"state": self._reset[0],
                                       "observation": self._reset[1]}),
                "calls": out, "checked": sorted(out)}

    def free(self):
        self.kept.clear()
        self.last = None
        for name in ("state", "runner", "env", "_reset", "_idx"):
            self.__dict__.pop(name, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def trace_context(self) -> dict:
        return {"calls": self.profiled, "steps": self.profiled * self.steps,
                "lanes": self.lanes}
