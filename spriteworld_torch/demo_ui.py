"""Interactive matplotlib demo UI for human play.

Counterpart of `spriteworld_tpu/demo_ui.py`, a rebuild of the reference's
demo_ui.py:38-334 on top of the port's dm_env adapter (the engine renders
on the device; the UI is a host-side view). Includes the image+rewards
panes, success border coloring, drag-and-drop mouse agent and WASD/arrows
embodied agent, `demo_overrides`, which overrides a config's action space
and renderers for interactive play, and `setup_run_ui`, which runs it.
matplotlib and the dm_env adapter are imported where they are used, so
the overrides need neither.
"""

from __future__ import annotations

import numpy as np

from spriteworld_torch.core import actions
from spriteworld_torch.core import renderers as renderers_lib


class MatplotlibUI:
    """Image pane + last-10-rewards stem plot (demo_ui.py:38-148)."""

    def __init__(self, render_size=(256, 256)):
        import matplotlib.pyplot as plt

        self._plt = plt
        self._fig, (self._ax_image, self._ax_scalar) = plt.subplots(
            1, 2, figsize=(9, 4.5))
        self._ax_image.set_title("Spriteworld")
        self._ax_image.set_xticks([])
        self._ax_image.set_yticks([])
        self._im = self._ax_image.imshow(
            np.zeros(render_size + (3,), dtype=np.uint8))
        self._ax_scalar.set_title("Last 10 rewards")
        self._rewards = []
        self._fig.canvas.mpl_connect(
            "key_release_event",
            lambda event: plt.close(self._fig)
            if event.key == "escape" else None)

    @property
    def figure(self):
        return self._fig

    def register_callbacks(self, agent):
        agent.register_callbacks(self._fig, self._ax_image)

    def update(self, timestep, action):
        del action
        img = timestep.observation["image"]
        self._im.set_data(img)
        success = bool(timestep.observation.get("success", False))
        for spine in self._ax_image.spines.values():
            spine.set_color("green" if success else "black")
            spine.set_linewidth(3 if success else 1)
        if timestep.reward is not None:
            self._rewards.append(timestep.reward)
        self._rewards = self._rewards[-10:]
        self._ax_scalar.clear()
        self._ax_scalar.set_title("Last 10 rewards")
        if self._rewards:
            self._ax_scalar.stem(
                np.arange(len(self._rewards)), self._rewards)
        self._fig.canvas.draw_idle()
        self._plt.pause(0.01)


class HumanDragAndDropAgent:
    """Two mouse clicks -> a 4-vector drag action (demo_ui.py:151-217)."""

    def __init__(self, render_size=(256, 256)):
        self._render_size = render_size
        self._clicks = []
        self._fig = None

    def register_callbacks(self, fig, ax_image):
        self._fig = fig
        self._ax_image = ax_image
        fig.canvas.mpl_connect("button_press_event", self._on_click)

    def _on_click(self, event):
        if event.inaxes is not self._ax_image:
            return
        h, w = self._render_size
        x = event.xdata / w
        y = 1.0 - event.ydata / h  # image row -> math y
        self._clicks.append((x, y))

    def step(self, timestep):
        del timestep
        import matplotlib.pyplot as plt

        self._clicks = []
        while len(self._clicks) < 2 and plt.fignum_exists(
                self._fig.number):
            plt.pause(0.05)
        if len(self._clicks) < 2:
            return None
        (x1, y1), (x2, y2) = self._clicks[:2]
        return np.asarray([x1, y1, x2, y2], dtype=np.float32)


class HumanEmbodiedAgent:
    """WASD/arrow keys + space-to-carry (demo_ui.py:220-295)."""

    _KEYMAP = {
        "up": 0, "w": 0,
        "left": 1, "a": 1,
        "down": 2, "s": 2,
        "right": 3, "d": 3,
    }

    def __init__(self):
        self._pending = None
        self._carry = 0
        self._fig = None

    def register_callbacks(self, fig, ax_image):
        del ax_image
        self._fig = fig
        fig.canvas.mpl_connect("key_press_event", self._on_key)

    def _on_key(self, event):
        if event.key == " ":
            self._carry = 1 - self._carry
        elif event.key in self._KEYMAP:
            self._pending = self._KEYMAP[event.key]

    def step(self, timestep):
        del timestep
        import matplotlib.pyplot as plt

        self._pending = None
        while self._pending is None and plt.fignum_exists(
                self._fig.number):
            plt.pause(0.05)
        if self._pending is None:
            return None
        return np.asarray([self._carry, self._pending], dtype=np.int32)


def demo_overrides(env_config, render_size=256, task_hsv_colors=True,
                   anti_aliasing=1, pil_exact=True):
    """Override a config's action space and renderers for interactive play
    (demo_ui.py:298-334), in place; returns the config.

    A SelectMove space (DragAndDrop too) becomes DragAndDrop(scale=0.5), an
    Embodied one stays; the renderers become an HSV (or, without
    `task_hsv_colors`, raw) image of render_size x render_size at
    `anti_aliasing` and `pil_exact`, and Success. Raises ValueError for
    another action space.
    """
    if isinstance(env_config["action_space"], actions.SelectMove):
        env_config["action_space"] = actions.DragAndDrop(scale=0.5)
    elif not isinstance(env_config["action_space"], actions.Embodied):
        raise ValueError(
            f"Demo UI does not support action space "
            f"{env_config['action_space']}")
    env_config["renderers"] = {
        "image": renderers_lib.ImageRenderer(
            image_size=(render_size, render_size),
            anti_aliasing=anti_aliasing,
            color_to_rgb="hsv" if task_hsv_colors else None,
            pil_exact=pil_exact),
        "success": renderers_lib.Success(),
    }
    return env_config


def setup_run_ui(env_config, render_size=256, task_hsv_colors=True,
                 anti_aliasing=1, device="cuda"):
    """Apply `demo_overrides` and run the interactive loop on `device`
    (demo_ui.py:298-334)."""
    from spriteworld_torch.adapters import dm_env_adapter

    demo_overrides(env_config, render_size, task_hsv_colors, anti_aliasing)
    if isinstance(env_config["action_space"], actions.Embodied):
        agent = HumanEmbodiedAgent()
    else:
        agent = HumanDragAndDropAgent((render_size, render_size))
    env = dm_env_adapter.Environment(**env_config, device=device)
    ui = MatplotlibUI((render_size, render_size))
    ui.register_callbacks(agent)

    import matplotlib.pyplot as plt

    timestep = env.reset()
    ui.update(timestep, None)
    while plt.fignum_exists(ui.figure.number):
        action = agent.step(timestep)
        if action is None:
            break
        timestep = env.step(action)
        ui.update(timestep, action)
