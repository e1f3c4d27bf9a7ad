"""Spriteworld's embodied goal-finding example
(`examples.goal_finding_embodied`) against its plain reference
(`perfbench/reference/`), on the CPU: the configuration file against
`get_config()`, the runner's reset and two rollout calls at 4 lanes on a
small frame at anti_aliasing 5, the reference's adhere-and-carry on
hand-made scenes beside the port's `Embodied.step`, its integer draws, the
bfloat16 control, two planted faults, and the action space's span, census
and reader."""

import types

import numpy as np
import pytest
import torch

from perfbench import check, harness, traffic
from perfbench.devtrace import Op, Trace
from perfbench.reference import engine, threefry

from spriteworld_torch.configs.examples import goal_finding_embodied
from spriteworld_torch.core import actions
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import renderers
from spriteworld_torch.ops import lane_random
from spriteworld_torch.utils import profiling

NAME = "examples.goal_finding_embodied"
CELL = "embodied.rollout"
SEED = 3_000_000_019  # above 2**31: the key takes both words
SMALL = 16  # a small frame at the example's anti_aliasing (80x80 canvas)
STATE = (("factors", "factors"), ("num", "num_sprites"),
         ("step_count", "step_count"), ("reset_next", "reset_next"),
         ("key", "key"))
ROLLOUT_CELLS = ["goal_finding.rollout", "sorting.rollout",
                 "goal_finding_clustering.rollout", "demo.rollout", CELL]


def _reference(image_size=(SMALL, SMALL)):
    """The configuration's reference module, its frame `image_size`."""
    mod = check.reference_module(harness.Layout().reference(NAME))
    return types.SimpleNamespace(
        build=lambda precision="float32": mod.build(precision, image_size),
        module=mod)


def _small_renderers():
    return {"image": renderers.ImageRenderer(
        image_size=(SMALL, SMALL), anti_aliasing=5, color_to_rgb="hsv")}


def _small_config():
    """The example's config with a SMALL x SMALL frame at AA=5."""
    return dict(goal_finding_embodied.get_config("train"),
                renderers=_small_renderers())


def test_the_configuration_file_builds_what_get_config_builds():
    layout = harness.Layout()
    config = layout.config(NAME)
    built = harness.env_kwargs(config)  # raises where a held size differs
    want = goal_finding_embodied.get_config()
    assert sorted(built) == sorted(want)
    assert type(built["action_space"]) is actions.Embodied
    assert vars(built["action_space"]).keys() == vars(
        want["action_space"]).keys()
    assert built["action_space"]._step_size == config["step_size"] == 0.05
    np.testing.assert_array_equal(built["action_space"]._motions,
                                  want["action_space"]._motions)
    assert sorted(built["renderers"]) == ["image"]
    image, want_image = built["renderers"]["image"], want["renderers"][
        "image"]
    assert vars(image) == vars(want_image)
    assert image.image_size == (64, 64) and image._anti_aliasing == 5
    assert built["max_episode_length"] == config["max_episode_length"] == 50
    assert built["init_sprites"].max_sprites == config["max_sprites"] == 7
    task = built["task"]
    assert type(task) is type(want["task"])
    assert task._terminate_distance == 0.075
    np.testing.assert_array_equal(task._goal_position, [0.5, 0.5])
    assert all(v == 0 for v in config["limits"].values())
    entry = next(c for c in layout.bench["configs"] if c["name"] == NAME)
    assert entry["reduced"] == [] and entry["file"].endswith(NAME + ".json")
    cell = layout.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        NAME, "rollout", 1)


def test_the_cell_reports_the_rollout_metrics_but_clusters_and_strips():
    layout = harness.Layout()
    per_layer = {m["name"] for m in layout.per_layer(CELL)}
    assert "env_step.action_ms.rollout" in per_layer
    assert not per_layer & {"env_step.clustering_ms.rollout",
                            "strip_render_roofline"}
    assert {m["name"] for m in layout.end_to_end(CELL)} == {
        "env_steps_per_s", "setup_s"}
    action = next(m for m in layout.bench["per_layer"]
                  if m["name"] == "env_step.action_ms.rollout")
    assert action["workloads"] == ROLLOUT_CELLS
    assert (action["layer"], action["source"], action["moves"]) == (
        "action space", "device_trace", "env_steps_per_s")


def test_runner_calls_equal_the_reference():
    """Reset state and image, then two 8-step rollout calls of the
    runner's random Embodied policy at 4 lanes, every episode 6 steps
    from its end, so that each lane ends one and starts the next: step
    types, rewards, images, each call's end state and the action key, bit
    for bit."""
    from spriteworld_torch.parallel import ShardedRunner

    lanes, steps = 4, 8
    runner = ShardedRunner(env_lib.Environment(**_small_config(),
                                               device="cpu"), lanes)
    state, ts = runner.reset(SEED)
    env = _reference().build()
    idx = np.arange(lanes)
    ref = env.reset(env.rng.block(threefry.key(SEED)[None],
                                  idx.astype(np.uint32)))
    for k, f in STATE:
        got = getattr(state, f).numpy()
        np.testing.assert_array_equal(
            check.words(got) if k == "key" else got, getattr(ref, k), k)
    assert ((ref.num >= 3) & (ref.num <= 7)).all()
    np.testing.assert_array_equal(env.observe(ref, "image"),
                                  ts.observation["image"].numpy())
    state.step_count.fill_(44)
    ref.step_count[:] = 44
    simulate = harness.Layout().loop("runner").simulate
    key = threefry.blocks(threefry.key(SEED), 1)
    seen = set()
    for _ in range(2):
        state, _, tss = runner.rollout(state, steps, return_timesteps=True)
        sts, rws, ims, ref, key = simulate(env, ref, key, idx, steps,
                                           "image")
        np.testing.assert_array_equal(sts, tss.step_type.numpy())
        np.testing.assert_array_equal(rws, tss.reward.numpy())
        np.testing.assert_array_equal(
            ims, tss.observation["image"].numpy().reshape(ims.shape))
        for k, f in STATE:
            got = getattr(state, f).numpy()
            np.testing.assert_array_equal(
                check.words(got) if k == "key" else got, getattr(ref, k), k)
        np.testing.assert_array_equal(key, check.words(runner.action_key))
        seen.update(int(s) for s in sts.ravel())
        assert not np.isnan(rws).any()  # every scene holds a target
    assert seen == {engine.FIRST, engine.MID, engine.LAST}
    assert ims.shape == (steps, lanes, SMALL, SMALL, 3) and ims.any()


# Hand-made scenes: (live sprites' positions, the body last; action);
# each sprite but the body a square of scale 0.2, the body a circle of
# 0.07; the slots past the live ones hold the default row, a square of
# 0.1 at (0.5, 0.5).
SCENES = {
    # The body's centre lies in slot 1 alone.
    "carry": ([(0.8, 0.8), (0.42, 0.41), (0.4, 0.4)], (1, 3), [1, 2]),
    "no_carry": ([(0.8, 0.8), (0.42, 0.41), (0.4, 0.4)], (0, 3), [2]),
    # In slots 0 and 1: the topmost, slot 1, moves.
    "two_under": ([(0.4, 0.43), (0.37, 0.4), (0.4, 0.4)], (1, 0), [1, 2]),
    # In no live sprite, though in the dead slot 3 past the body.
    "alone": ([(0.8, 0.8), (0.1, 0.1), (0.5, 0.5)], (1, 2), [2]),
    # Both moves pass the frame's right edge: clipped to x = 1.
    "clipped": ([(0.2, 0.2), (0.99, 0.5), (0.98, 0.5)], (1, 3), [1, 2]),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_reference_carries_the_topmost_sprite_under_the_body(scene):
    """The reference moves the carried sprite (where carry is set) and the
    body by the direction's 0.05 step, clipped to the frame; the port's
    Embodied moves the same sprites to the same float32 positions."""
    positions, (carry, direction), moved = SCENES[scene]
    env = _reference().build()
    f = np.tile(engine.DEFAULT_ROW, (1, 4, 1))
    f[0, :3, 2] = engine.SHAPE_IDS["square"]
    f[0, :3, 4] = 0.2
    f[0, 2, 2], f[0, 2, 4] = engine.SHAPE_IDS["circle"], 0.07
    f[0, :3, 0:2] = positions
    num = np.array([3], np.int32)
    action = np.array([[carry, direction, 0, 0]], np.float32)
    state = engine.State(f, num, np.zeros(1, np.int32),
                         np.zeros(1, bool), np.zeros((1, 2), np.uint32))
    new, step_type, _ = env.step(state, action)
    step = _reference().module.MOTIONS[direction]
    want = f[0, :, 0:2].copy()
    for i in moved:
        want[i] = np.clip(want[i] + step, 0, 1)
    assert (want[2] != f[0, 2, 0:2]).any()  # the body always moves
    if scene == "clipped":
        assert (want[moved, 0] == 1).all()
    np.testing.assert_array_equal(new.factors[0, :, 0:2], want)
    assert step_type[0] == engine.MID
    port, cost = actions.Embodied(step_size=0.05).step(
        torch.tensor([[carry, direction]], dtype=torch.int32),
        torch.from_numpy(f), torch.from_numpy(num), True,
        torch.zeros(1, 2, dtype=torch.int32))
    np.testing.assert_array_equal(port.numpy()[0, :, 0:2], want)
    assert cost.tolist() == [0.0]


def test_reference_draws_equal_embodied_sample():
    """The reference's random actions from lane keys are the port's
    `Embodied.sample` of the same keys, carry and direction alike."""
    keys = lane_random.split(lane_random.key(SEED), 512)
    got = actions.Embodied().sample(keys)
    env = _reference().build()
    want = env.random_actions(check.words(keys))
    assert got.dtype == torch.int32 and want.dtype == np.float32
    np.testing.assert_array_equal(want[:, :2], got.numpy())
    assert (want[:, 2:] == 0).all()
    assert set(np.unique(want[:, 0])) == {0, 1}
    assert set(np.unique(want[:, 1])) == {0, 1, 2, 3}


def test_the_bfloat16_reference_disagrees_with_the_port():
    """The cell's own loop and comparison at a few lanes on the small
    frame: the port's run reads 0 in every count; the reference computed
    in bfloat16 in its place reads off in each of the three."""
    layout = harness.Layout()
    config = layout.config(NAME)
    kwargs = dict(harness.env_kwargs(config), renderers=_small_renderers())
    mix = dict(layout.traffic("rollout"), lanes=4, steps_per_call=3,
               warmup_calls=1, check={"lanes": 4, "calls": 2})
    feed = traffic.build(layout, mix, kwargs, config["observation"], "cpu",
                         SEED)
    feed.setup(0.2)
    feed.window(0.2, False)
    rec = feed.records()
    feed.free()
    reference = _reference()
    correct, rows = check.verdict(
        feed.check(rec, reference, config["observation"]), config["limits"])
    assert correct, rows
    correct, rows = check.verdict(
        feed.check(rec, reference, config["observation"], control=True),
        config["limits"])
    assert not correct
    assert all(value > 0 for _, value, _ in rows), rows


def _reversed(step):
    def run(self, action, factors, num, keep_in_frame, key):
        back = torch.stack([action[:, 0], (action[:, 1] + 2) % 4], -1)
        return step(self, back, factors, num, keep_in_frame, key)
    return run


def _first_slot_body(step):
    def run(self, action, factors, num, keep_in_frame, key):
        return step(self, action, factors, torch.ones_like(num),
                    keep_in_frame, key)
    return run


@pytest.mark.parametrize("fault", [_reversed, _first_slot_body])
def test_a_broken_embodied_step_is_not_correct(fault, monkeypatch):
    """The cell's loop and comparison at a few lanes, the port's Embodied
    step broken: each direction reversed, or slot 0 taken for the body.
    The comparison reads off in the state and the images."""
    monkeypatch.setattr(actions.Embodied, "step",
                        fault(actions.Embodied.step))
    layout = harness.Layout()
    config = layout.config(NAME)
    kwargs = dict(harness.env_kwargs(config), renderers=_small_renderers())
    mix = dict(layout.traffic("rollout"), lanes=4, steps_per_call=3,
               warmup_calls=1, check={"lanes": 4, "calls": 2})
    feed = traffic.build(layout, mix, kwargs, config["observation"], "cpu",
                         SEED + 1)
    feed.setup(0.2)
    feed.window(0.2, False)
    rec = feed.records()
    feed.free()
    tally = feed.check(rec, _reference(), config["observation"])
    correct, rows = check.verdict(tally, config["limits"])
    assert not correct
    assert tally.counts["state_values_off"] > 0
    assert tally.counts["observation_values_off"] > 0


def test_the_reference_builds_the_example_by_default():
    env = _reference().module.build()
    assert env.image_size == (64, 64) and env.anti_aliasing == 5
    assert env.max_episode_length == 50 and env.scene.max_sprites == 7
    assert env.task.distance == np.float32(0.075)
    np.testing.assert_array_equal(
        _reference().module.MOTIONS,
        actions.Embodied(step_size=0.05)._motions)


# ---------------------------------------------------------------------- #
# The action space's span, its census and its reader.

def _captured_embodied_step(monkeypatch, lanes=3):
    """The node map of one runner step of the example (AA=1, a small
    frame) captured under the CPU stand-in of a CUDA capture."""
    from test_torch_profiling import _CapturedOnTheCpu

    from spriteworld_torch.parallel import runner as runner_lib

    cfg = dict(goal_finding_embodied.get_config(), renderers={
        "image": renderers.ImageRenderer(image_size=(SMALL, SMALL),
                                         anti_aliasing=1)})
    fake = _CapturedOnTheCpu()
    monkeypatch.setattr(profiling, "_driver", fake.driver)
    monkeypatch.setattr(profiling, "_current_stream", lambda: 0)
    runner = runner_lib.ShardedRunner(
        env_lib.Environment(**cfg, device="cpu"), lanes)
    state, _ = runner.reset(SEED)
    carry = runner_lib._Carry.like(state, runner.episode_returns,
                                   runner.action_key)
    with fake, profiling.capture("runner.step") as record:
        runner._step(carry, 1, True, None)
    return record


def _context(ops, steps):
    layout = harness.Layout()
    trace = Trace(ops, [("rollout", 0, 10**12)], [], {})
    return harness.Context(trace=trace, steps=steps, calls=1, lanes=3,
                           config=layout.config(NAME), tally=check.Tally(),
                           host_step_ms=[], layout=layout)


def test_a_captured_step_charges_the_action_space_to_env_action(
        monkeypatch):
    """One runner step under a capture: the Embodied step's nodes sit
    under `env.transition/env.action`, after the key split and before the
    integration; the census counts one `action.Embodied` step; the new
    reader adds the nodes under the span, and the transition's group
    still holds them."""
    from perfbench import nodemap

    record = _captured_embodied_step(monkeypatch)
    paths = [record.path(s) for _, s, _ in record.nodes]
    under = [k for k, p in enumerate(paths)
             if "env.action" in p.split("/")]
    assert under, "no node under env.action"
    assert all(paths[k].endswith("env.transition/env.action")
               for k in under)
    assert under == list(range(under[0], under[-1] + 1))  # one run
    assert {nodemap.group_of(paths[k]) for k in under} == {"transition"}
    assert record.census_table()["action.Embodied"] == {
        "step": {"evaluations": 1}}
    assert record.evaluations and all(
        cls != "Embodied" for cls, _ in record.evaluations)

    # Two replays, node k taking (k + 1) µs.
    monkeypatch.setattr(profiling, "graphs", lambda: [record])
    ops, t = [], 0
    for _ in range(2):
        for k, (_, _, name) in enumerate(record.nodes):
            dur = 1000 * (k + 1)
            ops.append(Op(name, t, t + dur, "kernel", 0, "cudaGraphLaunch"))
            t += dur + 500
    ctx = _context(ops, steps=2)
    reader = harness.Layout().reader("env_step.action_ms.rollout")
    want = sum(k + 1 for k in under) * 1e-3  # ms a step
    assert reader.read(ctx) == pytest.approx(want)
    transition = harness.Layout().reader("env_step.transition_ms.rollout")
    assert transition.read(ctx) > reader.read(ctx)


def test_the_action_reader_gives_none_without_the_span(monkeypatch):
    """A node map whose step opens no `env.action` (the parent's) and a
    program that keeps no graphs read None."""
    rec = profiling.GraphRecord("runner.step")
    for name, parent in (("runner.actions", -1), ("env.transition", -1),
                         ("env.task", 1), ("env.render", -1)):
        rec.spans.append(profiling._GraphSpan(name, parent))
    rec.nodes = [("kernel", 0, "a"), ("kernel", 1, "b"), ("kernel", 2, "c"),
                 ("kernel", 3, "d")]
    ops = [Op(n, 2000 * k, 2000 * k + 1000, "kernel", 0, "cudaGraphLaunch")
           for k, n in enumerate("abcd")]
    reader = harness.Layout().reader("env_step.action_ms.rollout")
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    assert reader.read(_context(list(ops), steps=1)) is None
    monkeypatch.setattr(profiling, "graphs", lambda: [])
    assert reader.read(_context(list(ops), steps=1)) is None


@pytest.mark.parametrize("space", ["SelectMove", "DragAndDrop", "Embodied"])
def test_every_action_space_counts_its_step_into_a_capture(space,
                                                           monkeypatch):
    """Each action space's step counts under `action.<Class>` during a
    capture, apart from the tasks' evaluations, and not off a capture."""
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    f = torch.from_numpy(np.tile(engine.DEFAULT_ROW, (2, 3, 1)))
    num = torch.tensor([3, 1], dtype=torch.int32)
    keys = torch.zeros(2, 2, dtype=torch.int32)
    a = getattr(actions, space)()
    action = a.sample(lane_random.split(lane_random.key(1), 2))
    with profiling.capture("step") as rec:
        a.step(action, f, num, True, keys)
        a.step(action, f, num, True, keys)
    a.step(action, f, num, True, keys)  # no capture: not counted
    assert rec.actions == {(space, "step"): 2}
    assert rec.evaluations == {}
    assert rec.census_table() == {f"action.{space}": {
        "step": {"evaluations": 2}}}


def test_a_step_with_tracing_off_records_nothing():
    """Tracing off and no capture: a step opens the shared null span
    everywhere, `env.action` included, and records no span."""
    env = env_lib.Environment(**_small_config(), device="cpu")
    state, _ = env.reset_batch(2)
    profiling.clear()
    assert profiling.annotate("env.action") is profiling._NULL
    env.step_batch(state, env.sample_action(env.lane_keys(2)))
    assert profiling.spans() == [] and profiling.dropped() == 0
    profiling.enable()
    try:
        env.step_batch(state, env.sample_action(env.lane_keys(2)))
        records = profiling.spans()
        paths = {profiling.path(records, i) for i in range(len(records))}
    finally:
        profiling.disable()
        profiling.clear()
    assert "env.transition/env.action" in paths
