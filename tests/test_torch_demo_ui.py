"""The port's demo UI, headless on matplotlib's Agg backend (as
tests/test_demo_ui.py runs the JAX one): setup_run_ui over the port's
dm_env adapter on the CPU with scripted human agents, the click and key
math, the reward pane, and the overrides bench_torch's demo config
shares."""

import matplotlib

matplotlib.use("Agg")

import dm_env  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import bench_torch  # noqa: E402
from spriteworld_torch import demo_ui  # noqa: E402
from spriteworld_torch.core import actions  # noqa: E402
from spriteworld_torch.core import renderers  # noqa: E402


class _Event:
    """Synthetic matplotlib event (only the fields the agents read)."""

    def __init__(self, **kw):
        self.inaxes = None
        self.xdata = self.ydata = None
        self.key = None
        self.__dict__.update(kw)


@pytest.mark.parametrize("config,agent,action", [
    ("cobra.goal_finding_new_shape", "HumanDragAndDropAgent",
     np.asarray([0.5, 0.5, 0.6, 0.6], np.float32)),
    ("examples.goal_finding_embodied", "HumanEmbodiedAgent",
     np.asarray([0, 1], np.int32)),
], ids=["drag_and_drop", "embodied"])
def test_setup_run_ui_headless(monkeypatch, config, agent, action):
    """reset -> UI update -> one step -> UI update -> the agent quits."""
    import importlib

    cfg = importlib.import_module(
        f"spriteworld_torch.configs.{config}").get_config("train")
    scripted = iter([action, None])
    steps = []
    monkeypatch.setattr(getattr(demo_ui, agent), "step",
                        lambda self, ts: (steps.append(ts), next(scripted))[1])
    updates = []
    update = demo_ui.MatplotlibUI.update
    monkeypatch.setattr(demo_ui.MatplotlibUI, "update",
                        lambda self, ts, a: (updates.append(ts),
                                             update(self, ts, a)))
    demo_ui.setup_run_ui(cfg, render_size=32, anti_aliasing=1, device="cpu")
    assert [ts.step_type for ts in updates] == [dm_env.StepType.FIRST,
                                                dm_env.StepType.MID]
    assert updates[-1].observation["image"].shape == (32, 32, 3)
    assert len(steps) == 2
    space = cfg["action_space"]
    assert isinstance(space, actions.Embodied if agent == "HumanEmbodiedAgent"
                      else actions.DragAndDrop)


def test_setup_run_ui_rejects_unknown_action_space():
    with pytest.raises(ValueError, match="does not support"):
        demo_ui.setup_run_ui({"action_space": object()}, device="cpu")


def test_setup_run_ui_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from spriteworld_torch.configs.cobra import clustering

    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_ui.setup_run_ui(clustering.get_config("train"))


def test_demo_overrides_are_bench_torch_demo_config():
    """bench_torch's demo config is demo_overrides on clustering, so the
    two cannot drift: DragAndDrop(scale=0.5), an HSV image, Success."""
    cfg = bench_torch.demo_config(render_size=64, anti_aliasing=3,
                                  pil_exact=False)
    space = cfg["action_space"]
    assert type(space) is actions.DragAndDrop and space._scale == 0.5
    image = cfg["renderers"]["image"]
    assert image.image_size == (64, 64) and image._anti_aliasing == 3
    assert not image._pil_exact and image._color_to_rgb is not None
    assert isinstance(cfg["renderers"]["success"], renderers.Success)
    assert set(cfg["renderers"]) == {"image", "success"}
    raw = demo_ui.demo_overrides(
        {"action_space": actions.Embodied(), "renderers": {}},
        render_size=16, task_hsv_colors=False)
    assert type(raw["action_space"]) is actions.Embodied
    assert raw["renderers"]["image"]._color_to_rgb is None


def test_ui_update_tracks_rewards_and_success():
    ui = demo_ui.MatplotlibUI((8, 8))
    obs = {"image": np.zeros((8, 8, 3), np.uint8), "success": True}
    for r in range(12):
        ui.update(dm_env.transition(reward=float(r), observation=obs), None)
    assert ui._rewards == [float(r) for r in range(2, 12)]  # the last 10
    spine = next(iter(ui._ax_image.spines.values()))
    assert spine.get_edgecolor()[:3] == (0.0, 128 / 255, 0.0)  # green


def test_drag_agent_click_math(monkeypatch):
    """Clicks through _on_click and the real step(): x = xdata / w,
    y = 1 - ydata / h (image row 0 is the top), clicks off the image
    axes ignored."""
    import matplotlib.pyplot as plt

    agent = demo_ui.HumanDragAndDropAgent((256, 128))
    fig, ax = plt.subplots()
    try:
        agent.register_callbacks(fig, ax)
        clicks = iter([
            _Event(inaxes=None, xdata=1.0, ydata=1.0),
            _Event(inaxes=ax, xdata=32.0, ydata=64.0),
            _Event(inaxes=ax, xdata=96.0, ydata=224.0),
        ])
        monkeypatch.setattr(plt, "pause",
                            lambda *_: agent._on_click(next(clicks)))
        action = agent.step(timestep=None)
    finally:
        plt.close(fig)
    np.testing.assert_allclose(
        action, [32 / 128, 1 - 64 / 256, 96 / 128, 1 - 224 / 256],
        atol=1e-6)
    assert action.dtype == np.float32


def test_embodied_agent_key_math(monkeypatch):
    """Space toggles carry; WASD and the arrows map to up, left, down,
    right (0-3)."""
    import matplotlib.pyplot as plt

    agent = demo_ui.HumanEmbodiedAgent()
    fig, ax = plt.subplots()
    try:
        agent.register_callbacks(fig, ax)
        for keys, want in [(["w"], [0, 0]), (["a"], [0, 1]),
                           (["down"], [0, 2]), (["right"], [0, 3]),
                           ([" ", "d"], [1, 3]), (["up"], [1, 0]),
                           ([" ", "left"], [0, 1])]:
            events = iter([_Event(key=k) for k in keys])
            monkeypatch.setattr(plt, "pause",
                                lambda *_: agent._on_key(next(events)))
            action = agent.step(timestep=None)
            np.testing.assert_array_equal(action, want)
            assert action.dtype == np.int32
    finally:
        plt.close(fig)
