"""The interactive demo's configuration (`demo.cobra_clustering`: COBRA
clustering under `demo_ui.demo_overrides` at run_demo_torch.py's
defaults) against its plain reference (`perfbench/reference/`), on the
CPU: the configuration file against the overrides, the runner's reset and
two rollout calls at 4 lanes on a small frame at anti_aliasing 10, the
reference's DragAndDrop, the bfloat16 control, and the strip render's
roofline count and reader."""

import types

import numpy as np
import pytest
import torch

from perfbench import check, harness, traffic
from perfbench.devtrace import Op, Trace
from perfbench.reference import engine, threefry

import run_demo_torch
from spriteworld_torch import demo_ui
from spriteworld_torch.configs.cobra import clustering
from spriteworld_torch.core import actions
from spriteworld_torch.core import environment as env_lib

NAME = "demo.cobra_clustering"
SEED = 3_000_000_019  # above 2**31: the key takes both words
SMALL = 24  # a small frame at the demo's anti_aliasing (240x240 canvas)
STATE = (("factors", "factors"), ("num", "num_sprites"),
         ("step_count", "step_count"), ("reset_next", "reset_next"),
         ("key", "key"))


def _reference(image_size=(SMALL, SMALL)):
    """The configuration's reference module, its frame `image_size`."""
    mod = check.reference_module(harness.Layout().reference(NAME))
    return types.SimpleNamespace(
        build=lambda precision="float32": mod.build(precision, image_size),
        module=mod)


def _demo_args(monkeypatch):
    """What run_demo_torch.py at its defaults passes to setup_run_ui."""
    seen = {}

    def setup_run_ui(config, *args, **kwargs):
        seen.update(config=config, args=args, kwargs=kwargs)

    monkeypatch.setattr(demo_ui, "setup_run_ui", setup_run_ui)
    assert run_demo_torch.main([]) == 0
    return seen


def _small_config():
    """The demo's config with a SMALL x SMALL frame, anti_aliasing 10."""
    return demo_ui.demo_overrides(clustering.get_config("train"),
                                  render_size=SMALL, task_hsv_colors=True,
                                  anti_aliasing=10)


def test_the_configuration_file_builds_what_demo_overrides_builds(
        monkeypatch):
    layout = harness.Layout()
    config = layout.config(NAME)
    built = harness.env_kwargs(config)  # raises where a held size differs
    seen = _demo_args(monkeypatch)
    assert seen["config"]["metadata"] == {"name": "clustering.py",
                                          "mode": "train"}
    want = demo_ui.demo_overrides(seen["config"], *seen["args"])
    assert sorted(built) == sorted(want)
    assert type(built["action_space"]) is actions.DragAndDrop
    assert vars(built["action_space"]) == vars(want["action_space"])
    assert sorted(built["renderers"]) == ["image", "success"]
    for name, r in want["renderers"].items():
        assert type(built["renderers"][name]) is type(r)
        assert vars(built["renderers"][name]) == vars(r), name
    image = built["renderers"]["image"]
    assert image.image_size == (256, 256) and image._anti_aliasing == 10
    assert image._pil_exact
    assert built["max_episode_length"] == config["max_episode_length"] == 50
    assert built["init_sprites"].max_sprites == config["max_sprites"] == 4
    cell = layout.cell("demo.rollout")
    assert cell["config"] == NAME and cell["chips"] == 1
    mix, rollout = layout.traffic(cell["traffic"]), layout.traffic("rollout")
    assert mix["lanes"] == 256
    # As the 2048-lane mix but for the lanes and the calls the comparison
    # takes: three calls of Pillow at 2560x2560 outlast 120 s a run.
    assert mix["check"] == dict(rollout["check"], calls=2)
    same = ("loop", "steps_per_call", "warmup_calls", "trace")
    assert [mix[k] for k in same] == [rollout[k] for k in same]
    assert all(v == 0 for v in config["limits"].values())


def test_runner_calls_equal_the_reference():
    """Reset state and image, then two 10-step rollout calls of the
    runner's random DragAndDrop policy at 4 lanes: step types, rewards,
    images, each call's end state and the action key, bit for bit."""
    from spriteworld_torch.parallel import ShardedRunner

    lanes, steps = 4, 10
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
    assert (ref.num == 4).all()
    np.testing.assert_array_equal(env.observe(ref, "image"),
                                  ts.observation["image"].numpy())
    simulate = harness.Layout().loop("runner").simulate
    key = threefry.blocks(threefry.key(SEED), 1)
    moved = 0
    for _ in range(2):
        state, _, tss = runner.rollout(state, steps, return_timesteps=True)
        start = ref.factors.copy()
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
        moved += int((start[..., 0:2] != ref.factors[..., 0:2]).any())
        assert np.isfinite(rws).all()
    assert ims.shape == (steps, lanes, SMALL, SMALL, 3) and ims.any()
    assert moved  # some drag hit a sprite


@pytest.mark.parametrize("click", ["top", "under", "miss"])
def test_reference_drag_and_drop_moves_the_topmost_hit_sprite(click):
    """Two overlapping squares: a drag from a point inside both moves the
    later (topmost) by (a[2:] - a[:2]) * 0.5; one inside the first alone
    moves it; one in neither moves nothing. The port's DragAndDrop moves
    the same sprite to the same float32 position."""
    env = _reference().build()
    f = np.tile(engine.DEFAULT_ROW, (1, 4, 1))
    f[0, :, 2] = engine.SHAPE_IDS["square"]
    f[0, :, 4] = 0.2
    f[0, :, 0:2] = [[0.3, 0.3], [0.4, 0.4], [0.8, 0.8], [0.8, 0.2]]
    num = np.array([2], np.int32)  # slots 2 and 3 are dead
    start = {"top": (0.37, 0.36), "under": (0.25, 0.22),
             "miss": (0.8, 0.8)}[click]
    action = np.array([[*start, 0.9, 0.13]], np.float32)
    state = engine.State(f, num, np.zeros(1, np.int32),
                         np.zeros(1, bool), np.zeros((1, 2), np.uint32))
    new, step_type, _ = env.step(state, action)
    delta = (action[0, 2:] - action[0, :2]) * np.float32(0.5)
    want = f[0, :, 0:2].copy()
    moved = {"top": 1, "under": 0, "miss": None}[click]
    if moved is not None:
        want[moved] = np.clip(want[moved] + delta, 0, 1)
        assert (want[moved] != f[0, moved, 0:2]).all()
    np.testing.assert_array_equal(new.factors[0, :, 0:2], want)
    assert step_type[0] == engine.MID
    port, _ = actions.DragAndDrop(scale=0.5).step(
        torch.from_numpy(action), torch.from_numpy(f),
        torch.from_numpy(num), True, torch.zeros(1, 2, dtype=torch.int32))
    np.testing.assert_array_equal(port.numpy()[0, :, 0:2], want)


def test_the_bfloat16_reference_disagrees_with_the_port():
    """The cell's own loop and comparison at a few lanes on the small
    frame: the port's run reads 0 in every count; the reference computed
    in bfloat16 in its place reads off in each of the three."""
    layout = harness.Layout()
    config = layout.config(NAME)
    kwargs = dict(harness.env_kwargs(config),
                  renderers=_small_config()["renderers"])
    mix = dict(layout.traffic("rollout_256"), lanes=4, steps_per_call=3,
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


def test_the_reference_renders_the_demo_frame_by_default():
    env = _reference().module.build()
    assert env.image_size == (256, 256) and env.anti_aliasing == 10
    assert env.move_scale == np.float32(0.5)
    assert env.max_episode_length == 50 and env.scene.max_sprites == 4


# ---------------------------------------------------------------------- #
# The strip render's roofline.

def _pillow_taps(in_size, out_size):
    """Pillow's taps of one Lanczos pass worked by hand for a downscale
    by 10 (support 30): an inside output's window [10x - 25, 10x + 35)
    holds 60; the first three start at 0 and the last three end at
    in_size."""
    assert in_size == 10 * out_size
    head = [35, 45, 55]  # windows [0, 35), [0, 45), [0, 55)
    tail = [55, 45, 35]  # [in - 55, in), [in - 45, in), [in - 35, in)
    return 60 * (out_size - 6) + sum(head) + sum(tail)


def test_strip_render_least_time_by_hand():
    r = harness.Layout().roofline("scene_raster")
    taps = _pillow_taps(2560, 256)
    assert taps == r.lanczos_taps(2560, 256) == 15270
    lanes, sprites = 256, 4
    bytes_ = lanes * (sprites * 10 * 4 + 256 * 256 * 3)
    macs = 3 * (2560 * taps + 256 * taps)  # h-pass rows, v-pass columns
    ops = 2 * lanes * macs
    assert r.work(lanes, (256, 256), 10, sprites) == (bytes_, ops)
    least = r.least_seconds(lanes, (256, 256), 10, sprites)
    assert least == pytest.approx(max(bytes_ / 3.35e12, ops / 1979e12))
    assert least == pytest.approx(ops / 1979e12)  # the passes bound it
    assert 33e-6 < least < 34e-6 and 50e6 < bytes_ < 51e6


def _ctx(ops, steps):
    layout = harness.Layout()
    spans = [("rollout", 0, 10**9), ("sync", 10**9, 10**9 + 1)]
    trace = Trace([Op(n, s, e, "kernel", 0, "cudaGraphLaunch")
                   for n, s, e in ops], spans, [], {})
    return harness.Context(trace=trace, steps=steps, calls=1, lanes=256,
                           config=layout.config(NAME), tally=check.Tally(),
                           host_step_ms=[], layout=layout)


def test_strip_render_roofline_reads_the_pair_a_step():
    reader = harness.Layout().reader("strip_render_roofline")
    least = harness.Layout().roofline("scene_raster").least_seconds(
        256, (256, 256), 10, 4)
    ns = least * 1e9
    # Two steps, each a strip_raster and a strip_vpass launch whose sum is
    # twice the least time: 50%.
    ops = []
    for step in range(2):
        t = step * 10**6
        ops += [("void strip_raster_kernel<true>(float const*)", t,
                 t + 1.5 * ns),
                ("strip_vpass_kernel(unsigned char const*)", t + 2 * ns,
                 t + 2.5 * ns),
                ("other_kernel", t + 3 * ns, t + 9 * ns)]
    assert reader.read(_ctx(ops, 2)) == pytest.approx(50.0, rel=1e-6)
    assert reader.read(_ctx([("scene_raster_kernel<true>", 0, 5)], 1)) \
        is None
    assert reader.read(_ctx(ops, 0)) is None


# ---------------------------------------------------------------------- #
# The render route in a capture's census.

def test_a_captured_step_counts_its_render_route(monkeypatch):
    """A step of the demo's env under a capture counts one render by its
    route and mode: the plain version here (CPU tensors)."""
    from spriteworld_torch.utils import profiling

    env = env_lib.Environment(**_small_config(), device="cpu")
    state, _ = env.reset_batch(torch.tensor([[0, 5], [0, 6]],
                                            dtype=torch.int32))
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    with profiling.capture("step") as rec:
        env.step_batch(state, torch.full((2, 4), 0.5))
    table = rec.census_table()
    assert table["render_route.plain"] == {
        "exact+lanczos": {"launches": 1, "blocks": 0}}
    assert not any(k.startswith("render_route.") and k != "render_route.plain"
                   for k in table)
