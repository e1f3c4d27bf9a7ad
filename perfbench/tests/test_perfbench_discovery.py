"""Cells, metrics, configurations, mixes and roofline counts are found by
the names in BENCHMARK.json; a new one is new files and entries only."""

import json

import pytest

from perfbench import harness

def test_every_entry_of_the_benchmark_has_its_files():
    layout = harness.Layout()
    bench = layout.bench
    for cell in bench["workloads"]:
        config = layout.config(cell["config"])
        assert config["name"] == cell["config"]
        assert layout.reference(cell["config"]).is_file()
        assert callable(layout.loop(layout.traffic(cell["traffic"])["loop"])
                        .Loop)
        e2e = {m["name"] for m in layout.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = layout.per_layer(cell["name"])
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e
            assert callable(layout.reader(m["name"]).read)
    for kernel in ("scene_raster", "lane_random"):
        assert callable(layout.roofline(kernel).least_seconds)


def test_benchmark_file_keeps_to_its_limits():
    bench = harness.Layout().bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(c["chips"] == 1 for c in bench["workloads"])
    for e in bench["workloads"] + bench["configs"]:
        assert 1 <= len(e["why"]) <= 200


# A test-only loop: fresh scenes of a few lanes from consecutive seeds,
# each compared with the reference's reset from the same seed.
RESETS_LOOP = '''
import time

import numpy as np
import torch

from perfbench import check as cmp
from perfbench import traffic
from perfbench.reference import engine, threefry


def check(rec, reference, observation, control=False):
    want_env = reference.build("float32")
    got_env = reference.build("bfloat16")
    tally = cmp.Tally()
    lanes = np.arange(rec["lanes"], dtype=np.uint32)
    for seed, got in rec["resets"]:
        keys = threefry.blocks(threefry.key(seed)[None], lanes)
        want = want_env.reset(keys)
        if control:
            c = got_env.reset(keys)
            got = {"state": engine.state_dict(c),
                   "observation": got_env.observe(c, observation)}
        tally.answer(cmp.state_off(tally, got["state"], want)
                     | cmp.observation_off(tally, got["observation"],
                                           want_env.observe(want,
                                                            observation), 1))
    return tally


class Loop:
    check = staticmethod(check)

    def __init__(self, mix, env_kwargs, observation, device, seed, tracer):
        self.mix, self.kwargs, self.observation = mix, env_kwargs, observation
        self.device, self.seed, self.tracer = device, seed, tracer
        self.resets = []

    def setup(self, seconds):
        from spriteworld_torch.core import environment as env_lib
        from spriteworld_torch.parallel import ShardedRunner

        env = env_lib.Environment(**self.kwargs, device=self.device)
        self.runner = ShardedRunner(env, self.mix["lanes"])
        self.idx = torch.arange(self.mix["lanes"])
        self._reset(self.seed)
        self.resets.clear()
        return {}

    def _reset(self, seed):
        with self.tracer.span("reset"):
            state, ts = self.runner.reset(seed)
        self.resets.append((seed, traffic.host({
            "state": traffic.lanes_of(state, self.idx),
            "observation": ts.observation[self.observation]})))

    def window(self, seconds, trace):
        t0 = time.perf_counter()
        while not self.resets or time.perf_counter() - t0 < seconds:
            self._reset(self.seed + len(self.resets))
        elapsed = time.perf_counter() - t0
        n = len(self.resets)
        return {"attempted": n * self.mix["lanes"], "elapsed": elapsed,
                "metrics": {"test.resets_per_s": n / elapsed},
                "info": {"calls": n}}

    def records(self):
        return {"lanes": self.mix["lanes"], "resets": self.resets}

    def free(self):
        self.__dict__.pop("runner", None)

    def trace_context(self):
        return {"calls": len(self.resets), "steps": 0,
                "lanes": self.mix["lanes"]}
'''

# A test-only reference: goal finding observed as its sprites' factors.
FACTORS_REFERENCE = '''
import pathlib

import numpy as np

from perfbench import check
from perfbench.reference import engine

BASE = check.reference_module(pathlib.Path(__file__).with_name(
    "cobra.goal_finding_new_position.py"))


class FactorsEnv(engine.Env):
    def observe(self, state, name="image"):
        if name != "factors":
            return super().observe(state, name)
        k = state.factors.shape[1]
        return {"factors": state.factors,
                "mask": np.arange(k) < state.num[:, None]}


def build(precision="float32"):
    env = BASE.build(precision)
    env.__class__ = FactorsEnv
    return env
'''


def _add_entries(root):
    """A test-only configuration without an image, a loop, two mixes, an
    end-to-end metric, a per-layer metric and a roofline count: files and
    BENCHMARK.json entries, nothing else."""
    pb = root / "perfbench"
    config = json.loads((pb / "configs" /
                         "cobra.goal_finding_new_position.json").read_text())
    for key in ("image_size", "anti_aliasing", "color_to_rgb"):
        del config[key]
        config["holds"].pop(key, None)
    config.update(
        name="test.goal_factors", renderers=["factors"], observation="factors",
        overrides={"renderers": {"factors": {
            "call": "spriteworld_torch.core.renderers:SpriteFactors"}}})
    (pb / "configs" / "test.goal_factors.json").write_text(json.dumps(config))
    (pb / "reference" / "test.goal_factors.py").write_text(FACTORS_REFERENCE)
    (pb / "loops" / "test_resets.py").write_text(RESETS_LOOP)
    (pb / "traffic" / "test_resets.json").write_text(json.dumps(
        {"loop": "test_resets", "lanes": 3}))
    mix = json.loads((pb / "traffic" / "rollout.json").read_text())
    mix["lanes"] = 2
    (pb / "traffic" / "test_two_lanes.json").write_text(json.dumps(mix))
    (pb / "metrics" / "test.calls.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    (pb / "roofline" / "test_kernel.py").write_text(
        "def least_seconds(n):\n    return n / 1e9\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "test.goal_factors", "source": "https://example.org",
        "file": "perfbench/configs/test.goal_factors.json", "reduced": [],
        "why": "test-only"})
    bench["workloads"] += [
        {"name": "test.cell", "config": "test.goal_factors",
         "traffic": "test_resets", "chips": 1, "why": "test-only"},
        {"name": "test.factors_rollout", "config": "test.goal_factors",
         "traffic": "test_two_lanes", "chips": 1, "why": "test-only"}]
    bench["end_to_end"].insert(0, {
        "name": "test.resets_per_s", "unit": "resets/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": ["test.cell"]})
    bench["end_to_end"][1]["workloads"].append("test.factors_rollout")
    bench["per_layer"].append({
        "name": "test.calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "runner",
        "moves": "env_steps_per_s", "workloads": ["test.factors_rollout"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_test_only_entry_is_discovered_and_runs(tiny_layout):
    root = tiny_layout.root
    _add_entries(root)
    layout = harness.Layout(root)
    assert layout.cell("test.cell")["traffic"] == "test_resets"
    assert [m["name"] for m in layout.end_to_end("test.cell")] == [
        "test.resets_per_s", "setup_s"]
    assert [m["name"] for m in layout.per_layer("test.factors_rollout")] == [
        "test.calls"]
    assert layout.roofline("test_kernel").least_seconds(3) == 3e-9

    result, info, rows = harness.run(layout, "test.cell", 7, 0.2, False,
                                     "cpu")
    assert result["correct"], rows
    assert set(result["metrics"]) == {"test.resets_per_s", "setup_s"}
    assert result["attempted"] == 3 * info["calls"] > 0

    result, info, rows = harness.run(layout, "test.factors_rollout", 7, 0.2,
                                     True, "cpu")
    assert result["correct"], rows
    assert result["metrics"]["test.calls"]["value"] == 2.0
    assert dict((n, v) for n, v, _ in rows)["observation_values_off"] == 0
    assert result["attempted"] == 2 * 3 * (info["calls"] + 2)


def test_a_loop_without_its_file_is_named(tiny_layout):
    with pytest.raises(FileNotFoundError):
        tiny_layout.loop("no_such_loop")


def test_a_missing_file_is_named(tiny_layout):
    with pytest.raises(FileNotFoundError):
        tiny_layout.reader("no.such_metric")
