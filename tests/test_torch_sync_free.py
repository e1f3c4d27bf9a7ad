"""The port's step makes no host sync, so a CUDA graph can capture it.

A `TorchFunctionMode` raises on every call that reads the device from the
host or copies a host value to it (`nonzero`, `item`, `tolist`, a tensor's
`__bool__`/`__int__`/`__float__`/`__index__`, `torch.tensor`, boolean-mask
indexing, `multinomial`, ...). On the CPU those calls cost nothing, so the
mode is what shows that the CUDA path would not make them; on the card,
chip_smoke.py runs the eager step under `torch.cuda.set_sync_debug_mode`
("error") too. Also here: the sampling that made the step sync-free keeps
its statistics, and rejection drawn in rounds gives each element the first
accepted proposal of its own sequence, as the per-element do-while loop
does.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import bench_torch
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core.state import StepType
from spriteworld_torch.ops import lane_random
from spriteworld_torch.parallel import ShardedRunner
from spriteworld_torch.parallel import runner as runner_lib

_SYNCS = {
    torch.Tensor.nonzero, torch.nonzero, torch.argwhere, torch.Tensor.item,
    torch.Tensor.tolist, torch.Tensor.__bool__, torch.Tensor.__int__,
    torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.numpy,
    torch.Tensor.cpu, torch.multinomial, torch.Tensor.multinomial,
    torch.tensor, torch.as_tensor, torch.unique, torch.masked_select,
    torch.Tensor.masked_select, torch.bincount, torch.Tensor.bincount,
    torch.repeat_interleave,
}


class NoHostSync(TorchFunctionMode):
    """Raises on a torch call that would sync with the card or copy a host
    value to it; `allow` lets the calls through (the runner's one read a
    chunk)."""

    allow = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not self.allow:
            if func in _SYNCS:
                raise AssertionError(f"host sync: {func}")
            if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
                index = args[1] if isinstance(args[1], tuple) else (args[1],)
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in index):
                    raise AssertionError("host sync: boolean-mask index")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_syncs():
    x = torch.arange(4.0)
    for call in (lambda: bool(x.any()), lambda: x.nonzero(),
                 lambda: int(x.sum()), lambda: x[x > 1], lambda: x.tolist(),
                 lambda: torch.tensor([1.0]), lambda: float(x[0]),
                 lambda: torch.multinomial(x + 1, 2)):
        with pytest.raises(AssertionError, match="host sync"):
            with NoHostSync():
                call()


def _config_env(name, seed=0):
    mod = importlib.import_module(f"spriteworld_torch.configs.{name}")
    cfg = mod.get_config("train")
    cfg["renderers"]["success"] = trenderers.Success()
    return tenvironment.Environment(**cfg, device="cpu", seed=seed)


# bench_torch's workloads (the slice's main path) at small canvases.
_ENVS = {
    "image64_aa1": lambda: bench_torch.build_env(
        anti_aliasing=1, image_size=(16, 16), device="cpu"),
    "image64_aa5": lambda: bench_torch.build_env(
        anti_aliasing=5, image_size=(16, 16), device="cpu"),
    "image64_aa5_fast": lambda: bench_torch.build_env(
        anti_aliasing=5, image_size=(16, 16), pil_exact=False,
        device="cpu"),
    "factors": lambda: bench_torch.build_factors_env(device="cpu"),
    "sorting": lambda: bench_torch.config_env("cobra.sorting", device="cpu"),
    "clustering": lambda: bench_torch.config_env("cobra.clustering",
                                                 device="cpu"),
    "embodied": lambda: bench_torch.config_env(
        "examples.goal_finding_embodied", device="cpu"),
    "demo": lambda: bench_torch.build_demo_env(
        anti_aliasing=2, render_size=16, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(_ENVS))
def test_reset_and_step_make_no_host_sync(name):
    env = _ENVS[name]()
    b = 4
    keys = lane_random.split(lane_random.key(0), (5, b))
    state, _ = env.reset_batch(keys[0])  # fills the device-constant caches
    env.step_batch(state, env.sample_action(keys[1]))
    with NoHostSync():
        state, ts = env.reset_batch(keys[0])
        for t in range(4):
            state, ts = env.step_batch(state, env.sample_action(keys[t + 1]))
    assert ts.step_type.shape == (b,)


@pytest.mark.parametrize("name", ["cobra.goal_finding_new_position",
                                  "examples.goal_finding_clustering",
                                  "cobra.sorting"])
def test_runner_reads_the_host_once_a_chunk(name, monkeypatch):
    """The runner's steps make no host sync, rejecting configs included
    (inside the runner a rejection node defers to the chunk boundary); the
    chunk reads the device once."""
    env = _config_env(name)
    runner = ShardedRunner(env, 4)
    state, _ = runner.reset(0)
    runner.rollout(state, 2)
    mode = NoHostSync()
    reads = []
    to_host = runner_lib._to_host

    def counted(t):
        reads.append(t.numel())
        mode.allow = True
        try:
            return to_host(t)
        finally:
            mode.allow = False

    monkeypatch.setattr(runner_lib, "_to_host", counted)
    with mode:
        for _ in range(3):
            state, m = runner.rollout(state, 5)
    assert reads == [5, 5, 5] and runner.reruns == 0
    assert m.steps == 20


def test_reset_lanes_take_the_fresh_scene():
    """The select: lanes with reset_next take a fresh scene (step count 0,
    FIRST, reward 0, discount 1), every other lane its stepped state."""
    env = bench_torch.build_factors_env(device="cpu", seed=3)
    b = 64
    state, _ = env.reset_batch(b)
    state.reset_next = torch.arange(b) % 3 == 0
    state.step_count = torch.full((b,), 7, dtype=torch.int32)
    actions = env.sample_action(lane_random.split(lane_random.key(4), b))
    new, ts = env.step_batch(state, actions)
    # The same keys, no lane resetting: the stepped state of every lane.
    calm = tstate.EnvState(**{n: getattr(state, n).clone()
                              for n in tstate.STATE_FIELDS})
    calm.reset_next = torch.zeros(b, dtype=torch.bool)
    stepped, sts = env.step_batch(calm, actions)
    r = state.reset_next
    assert torch.equal(new.factors[~r], stepped.factors[~r])
    assert torch.equal(ts.reward[~r].isnan(), sts.reward[~r].isnan())
    assert (new.step_count[~r] == 8).all() and (new.step_count[r] == 0).all()
    assert (ts.step_type[r] == StepType.FIRST).all()
    assert (ts.step_type[~r] != StepType.FIRST).all()
    assert (ts.reward[r] == 0).all() and (ts.discount[r] == 1).all()
    assert not new.reset_next[r].any()
    # Fresh scenes are new draws of the goal-finding scene.
    target = bench_torch.goal_finding_parts()[1].gens[0].factor_dist
    spec = tstate.factors_to_dict(new.factors[r])
    assert target.contains(spec)[:, 0].all()
    assert not torch.equal(new.factors[r], state.factors[r])


def test_masked_mixture_and_sample_generator_keep_their_statistics():
    """Every component draws for every element; each element keeps its own
    component's draw, with the mixture's probabilities (a zero-probability
    component never)."""
    keys = lane_random.split(lane_random.key(11), 20000)
    mix = tdistribs.Mixture([tdistribs.Continuous("x", 0.0, 0.1),
                             tdistribs.Continuous("x", 0.4, 0.5),
                             tdistribs.Continuous("x", 0.8, 0.9)],
                            probs=[0.2, 0.0, 0.8])
    n = 20000
    x = mix.sample(keys)["x"]
    low = (x < 0.1).double().mean()
    assert abs(float(low) - 0.2) < 0.015
    assert ((x < 0.1) | ((x >= 0.8) & (x < 0.9))).all()
    assert abs(float(x[x >= 0.8].double().mean()) - 0.85) < 0.002
    d = tdistribs.Discrete("c0", [1.0, 2.0, 3.0], probs=[3, 0, 1])
    v = d.sample(keys)["c0"]
    assert not (v == 2.0).any()
    assert abs(float((v == 1.0).double().mean()) - 0.75) < 0.015

    one = tgenerators.generate_sprites(
        tdistribs.Continuous("x", 0.2, 0.3), num_sprites=1)
    two = tgenerators.generate_sprites(
        tdistribs.Continuous("x", 0.6, 0.7), num_sprites=2)
    pick = tgenerators.sample_generator([one, two], p=[0.7, 0.3])
    f, num, ok = pick.sample_with_status(keys)
    assert ok.all() and set(num.unique().tolist()) == {1, 2}
    assert abs(float((num == 1).double().mean()) - 0.7) < 0.015
    xs = f[..., tstate.X]
    assert ((xs[num == 1, 0] >= 0.2) & (xs[num == 1, 0] < 0.3)).all()
    assert ((xs[num == 2] >= 0.6) & (xs[num == 2] < 0.7)).all()
    assert (f[num == 1, 1] == torch.from_numpy(tstate.DEFAULT_FACTORS)).all()


class _Recorded(tdistribs.Continuous):
    """Continuous, recording every proposal block it draws."""

    def __init__(self, *args):
        super().__init__(*args)
        self.blocks = []

    def sample_with_status(self, key):
        spec, ok = super().sample_with_status(key)
        self.blocks.append(spec[self.key].clone())
        return spec, ok


def _first_accepted(blocks, accept, max_tries):
    """The do-while loop per element over its own proposal sequence: the
    first accepted proposal (or the last, and not ok)."""
    seq = torch.cat([b.reshape(-1, b.shape[-1]) for b in blocks])[:max_tries]
    hit = accept(seq)
    first = torch.where(hit.any(0), hit.to(torch.int8).argmax(0),
                        seq.shape[0] - 1)
    return seq.gather(0, first[None])[0], hit.any(0)


@pytest.mark.parametrize("rounds", [3, tdistribs.REJECTION_ROUNDS])
def test_rejection_rounds_equal_the_per_element_loop(rounds, monkeypatch):
    """At an acceptance rate of 3%, many elements are still pending after
    the first round; each ends with the first accepted proposal of its own
    sequence, as the per-element do-while loop gives it."""
    monkeypatch.setattr(tdistribs, "REJECTION_ROUNDS", rounds)
    base = _Recorded("x", 0.0, 1.0)
    sel = tdistribs.Selection(base, tdistribs.Continuous("x", 0.0, 0.03))
    spec, ok = sel.sample_with_status(
        lane_random.split(lane_random.key(2), (64,)))
    assert len(base.blocks) > 1  # rounds past the first ran
    want, found = _first_accepted(base.blocks, lambda v: v < 0.03,
                                  tdistribs.MAX_REJECTION_TRIES)
    assert torch.equal(spec["x"], want) and torch.equal(ok, found)
    assert ok.all()


def test_deferred_rejection_flags_pending_and_keeps_the_draws():
    """Inside defer_rejection the node stops after its first round and sets
    the flag where elements are pending (reporting them not ok); outside,
    from the same keys, its first round draws the same."""
    sel = tdistribs.Selection(tdistribs.Continuous("x", 0.0, 1.0),
                              tdistribs.Continuous("x", 0.0, 0.03))
    flag = torch.zeros((), dtype=torch.bool)
    with tdistribs.defer_rejection(flag):
        spec, ok = sel.sample_with_status(
            lane_random.split(lane_random.key(4), (256,)))
    assert bool(flag) and not ok.all() and ok.any()
    full, full_ok = sel.sample_with_status(
        lane_random.split(lane_random.key(4), (256,)))
    assert full_ok.all()
    assert torch.equal(spec["x"][ok], full["x"][ok])

    easy = tdistribs.SetMinus(tdistribs.Continuous("x", 0.0, 1.0),
                              tdistribs.Continuous("x", 0.0, 0.25))
    flag.zero_()
    with tdistribs.defer_rejection(flag):
        spec, ok = easy.sample_with_status(
            lane_random.split(lane_random.key(5), (256,)))
    assert not bool(flag) and ok.all()
    again, _ = easy.sample_with_status(
        lane_random.split(lane_random.key(5), (256,)))
    assert torch.equal(spec["x"], again["x"])


def test_fail_fast_gives_ok_false(monkeypatch):
    """An exhausted child stops the outer loop at once, with or without
    deferral: ok=False, one proposal block of the child."""
    monkeypatch.setattr(tdistribs, "MAX_REJECTION_TRIES", 40)
    empty = tdistribs.SetMinus(tdistribs.Continuous("x", 0.0, 1.0),
                               tdistribs.Continuous("x", 0.0, 1.0))
    calls = []
    orig = empty.sample_with_status

    def counted(key):
        calls.append(tuple(key.shape[:-1]))
        return orig(key)

    empty.sample_with_status = counted
    outer = tdistribs.Selection(empty, tdistribs.Continuous("x", 0.0, 0.5))
    _, ok = outer.sample_with_status(
        lane_random.split(lane_random.key(0), (5,)))
    assert not ok.any() and len(calls) == 1
    flag = torch.zeros((), dtype=torch.bool)
    with tdistribs.defer_rejection(flag):
        _, ok = outer.sample_with_status(
            lane_random.split(lane_random.key(0), (5,)))
    assert not ok.any() and len(calls) == 2 and bool(flag)


def _low_acceptance_env(seed=0):
    """Goal finding whose positions come from a 4%-acceptance Selection."""
    task, _ = bench_torch.goal_finding_parts()
    pos = tdistribs.Selection(
        tdistribs.Product([tdistribs.Continuous("x", 0.0, 1.0),
                           tdistribs.Continuous("y", 0.1, 0.9)]),
        tdistribs.Continuous("x", 0.3, 0.34))
    dist = tdistribs.Product([
        pos, tdistribs.Discrete("shape", ["square", "triangle"]),
        tdistribs.Continuous("c0", 0.0, 0.15),
        tdistribs.Continuous("scale", 0.1, 0.2)])
    return tenvironment.Environment(
        task=task, action_space=bench_torch.action_lib.SelectMove(
            scale=0.25),
        renderers={"image": trenderers.ImageRenderer((8, 8)),
                   "success": trenderers.Success()},
        init_sprites=tgenerators.generate_sprites(dist, num_sprites=3),
        max_episode_length=2, device="cpu", seed=seed)


def test_runner_reruns_a_chunk_whose_rejection_ran_past_its_rounds():
    """A chunk whose fresh scenes leave elements pending after the first
    round runs again eagerly from its start, and ends equal to the plain
    eager loop of step_batch from the same start: every scene sampled
    through."""
    env = _low_acceptance_env()
    runner = ShardedRunner(env, 16)
    start, _ = runner.reset(1)
    action_key = runner.action_key
    state, _, tss = runner.rollout(start, 4, return_timesteps=True)
    assert runner.reruns == 1
    assert state.sample_ok.all()

    want = start
    for t in range(4):
        action_key, step_key = lane_random.split(action_key, 2)
        want, ts = env.step_batch(
            want, env.sample_action(lane_random.split(step_key, 16)))
        assert torch.equal(ts.observation["image"].reshape(16, -1),
                           tss.observation["image"][t])
        assert torch.equal(ts.step_type, tss.step_type[t])
    for name in tstate.STATE_FIELDS:
        assert torch.equal(getattr(state, name), getattr(want, name)), name


def _rejection_nodes(node):
    """The rejection nodes of a generator or distribution tree, each with
    its proposal and acceptance test."""
    if isinstance(node, tdistribs.SetMinus):
        here = [(node.base, lambda s, n=node: ~n.hold_out.contains(s))]
        return here + _rejection_nodes(node.base)
    if isinstance(node, tdistribs.Selection):
        return ([(node.base, node.filtering.contains)]
                + _rejection_nodes(node.base))
    if isinstance(node, tdistribs.Intersection):
        prop = node.components[node.index_for_sampling]
        return [(prop, node.contains)] + _rejection_nodes(prop)
    children = []
    for attr in ("components", "gens"):
        children += list(getattr(node, attr, []))
    for attr in ("factor_dist", "gen"):
        if hasattr(node, attr):
            children.append(getattr(node, attr))
    return [r for c in children for r in _rejection_nodes(c)]


@pytest.mark.parametrize("name", ["cobra.goal_finding_new_position",
                                  "examples.goal_finding_clustering"])
def test_rejection_rounds_cover_the_rejecting_configs(name, capsys):
    """Each rejection node of the rejecting configs accepts often enough
    that an element is still pending after REJECTION_ROUNDS proposals with
    chance below 1e-9 (the rates printed are PERF.md's)."""
    mod = importlib.import_module(f"spriteworld_torch.configs.{name}")
    nodes = _rejection_nodes(mod.get_config("train")["init_sprites"])
    assert nodes
    keys = lane_random.split(lane_random.key(0), 200_000)
    for propose, accept in nodes:
        rate = float(accept(propose.sample(keys)).double().mean())
        pending = (1 - rate) ** tdistribs.REJECTION_ROUNDS
        with capsys.disabled():
            print(f"\n{name}: acceptance {rate:.4f}, pending after "
                  f"{tdistribs.REJECTION_ROUNDS} rounds {pending:.2e}")
        assert pending < 1e-9
