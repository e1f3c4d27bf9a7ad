"""The port's entry scripts on the CPU: example_run_loop_torch (one log
line per finished episode; its masked per-lane bookkeeping against a
per-lane reference loop over the same trace), make_gifs_torch (a GIF of a
scripted episode) and run_demo_torch (its flags reach setup_run_ui)."""

import logging
import os
import re
import warnings

import numpy as np
import pytest
from PIL import Image

import example_run_loop_torch
import make_gifs_torch
import run_demo_torch
from spriteworld_torch.core import environment

_EMBODIED = "spriteworld_torch.configs.examples.goal_finding_embodied"


def test_run_logs_each_episode(caplog):
    with caplog.at_level(logging.INFO, logger="example_run_loop_torch"):
        episodes = example_run_loop_torch.run(
            config=_EMBODIED, num_episodes=1, num_envs=4, device="cpu")
    lines = [r.getMessage() for r in caplog.records
             if "Episode done" in r.getMessage()]
    # The final step may finish several lanes at once: >= 4, < 8.
    assert 4 <= len(lines) == len(episodes) < 8
    for line, (lane, success, reward) in zip(lines, episodes):
        m = re.match(r"Episode done \(lane (\d+)\)\. Success = (True|False),"
                     r" Reward = (\S+)", line)
        assert m, line
        assert int(m.group(1)) == lane and 0 <= lane < 4
        assert m.group(2) == str(success)
        assert float(m.group(3)) == pytest.approx(reward, nan_ok=True)


def test_bookkeeping_equals_a_per_lane_reference_loop(monkeypatch):
    """run()'s episodes equal the reference's append-then-nanmean lists
    replayed over the (step type, reward, success) trace run() stepped."""
    trace = []
    step = environment.BatchedEnvironment.step

    def recording(self, state, actions):
        state, ts = step(self, state, actions)
        trace.append((ts.step_type.numpy().copy(), ts.reward.numpy().copy(),
                      ts.observation["success"].numpy().copy()))
        return state, ts

    monkeypatch.setattr(environment.BatchedEnvironment, "step", recording)
    got = example_run_loop_torch.run(
        config="spriteworld_torch.configs.cobra.goal_finding_new_shape",
        num_episodes=2, num_envs=3, device="cpu")
    lists = [[] for _ in range(3)]
    want = []
    for step_types, rewards, success in trace:
        for lane in range(3):
            if step_types[lane] == 0:
                continue
            lists[lane].append(rewards[lane])
            if step_types[lane] == 2:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    want.append((lane, bool(success[lane]),
                                 float(np.nanmean(lists[lane]))))
                lists[lane] = []
    assert len(got) == len(want) >= 6
    for (gl, gs, gr), (wl, ws, wr) in zip(got, want):
        assert (gl, gs) == (wl, ws)
        assert gr == pytest.approx(wr, rel=1e-6, nan_ok=True)  # float64 sums


def test_run_loop_main_parses_its_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(example_run_loop_torch, "run",
                        lambda *a: seen.__setitem__("args", a))
    assert example_run_loop_torch.main(
        ["--config", _EMBODIED, "--num_envs", "2", "--render_images",
         "--device", "cpu"]) == 0
    assert seen["args"] == (_EMBODIED, "train", 2, 2, True, "cpu")
    example_run_loop_torch.main([])
    assert seen["args"][-1] == "cuda"


def test_make_gif_on_the_cpu(tmp_path):
    path = make_gifs_torch.make_gif("goal_finding_video", str(tmp_path),
                                    seed=4, scale=2, device="cpu",
                                    max_steps=8)
    assert os.path.exists(path)
    im = Image.open(path)
    assert 2 <= im.n_frames <= 9
    assert im.size == (128, 128)


def test_make_gifs_main_writes_into_a_directory_git_ignores(
        monkeypatch, tmp_path):
    """The default --out_dir is gifs_torch/, which .gitignore lists (the
    JAX package's reference GIFs under gifs/ stay untouched)."""
    calls = []
    monkeypatch.setattr(make_gifs_torch, "make_gif",
                        lambda *a: calls.append(a) or "x.gif")
    monkeypatch.chdir(tmp_path)
    assert make_gifs_torch.main(["--device", "cpu"]) == 0
    assert [c[0] for c in calls] == list(make_gifs_torch.CONFIGS)
    assert {c[1:] for c in calls} == {("gifs_torch", 1, 3, "cpu")}
    assert (tmp_path / "gifs_torch").is_dir()
    root = os.path.dirname(os.path.abspath(make_gifs_torch.__file__))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "/gifs_torch/" in f.read().split()


def test_run_demo_parses_flags_and_calls_setup_run_ui(monkeypatch):
    calls = []
    monkeypatch.setattr(run_demo_torch.demo_ui, "setup_run_ui",
                        lambda *a, **k: calls.append((a, k)))
    assert run_demo_torch.main(["--render_size", "64", "--device", "cpu",
                                "--no-task_hsv_colors"]) == 0
    (config, size, hsv, aa), kw = calls[-1]
    assert (size, hsv, aa, kw) == (64, False, 10, {"device": "cpu"})
    assert "action_space" in config
    run_demo_torch.main([])
    (_, size, hsv, aa), kw = calls[-1]
    assert (size, hsv, aa, kw) == (256, True, 10, {"device": "cuda"})
