"""The task's spans and counters (`core/tasks.py`, `utils/profiling.py`):
a span per subtask of a MetaAggregated, the census of task evaluations
and of the render's sprite slots, and the benchmark's two readers of the
task's nodes (`perfbench/spans.py`)."""

import pytest

from spriteworld_torch.utils import profiling


def _env(lanes=2):
    from spriteworld_torch.configs.examples import goal_finding_clustering
    from spriteworld_torch.core import environment, renderers

    cfg = goal_finding_clustering.get_config("train")
    cfg["renderers"] = {"image": renderers.ImageRenderer(
        image_size=(16, 16), anti_aliasing=1)}
    env = environment.Environment(**cfg, device="cpu")
    state, _ = env.reset_batch(lanes)
    return env, state, env.sample_action(env.lane_keys(lanes))


SUBTASKS = ("env.task.Clustering#0", "env.task.FindGoalPosition#1",
            "env.task.FindGoalPosition#2")


def test_a_step_opens_a_span_per_subtask_under_env_task():
    env, state, actions = _env()
    profiling.clear()
    profiling.enable()
    try:
        env.step_batch(state, actions)
        records = profiling.spans()
        paths = {profiling.path(records, i) for i in range(len(records))}
    finally:
        profiling.disable()
        profiling.clear()
    for where in ("env.transition/env.task", "env.transition/env.fresh/"
                  "env.task", "env.render/env.task"):
        for name in SUBTASKS:
            assert f"{where}/{name}" in paths, (where, name)
    assert not any(p.endswith("#3") and "env.task." in p for p in paths)


def test_a_capture_counts_task_evaluations_by_class_and_method(
        monkeypatch):
    """One step: the transition's reward, success and validity, the fresh
    scene's validity and the render's success. A zero-bonus reward asks
    for no success; each Clustering call labels its sprites once."""
    env, state, actions = _env()
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    with profiling.capture("step") as record:
        env.step_batch(state, actions)
    census = record.census_table()
    tasks = {k: {m: v["evaluations"] for m, v in row.items()}
             for k, row in census.items() if k.startswith("task.")}
    assert tasks == {
        "task.MetaAggregated": {"reward": 1, "success": 2, "valid": 2},
        "task.Clustering": {"reward": 1, "success": 2, "valid": 2,
                            "membership": 5},
        "task.FindGoalPosition": {"reward": 2, "success": 4}}
    names = [s.name for s in record.spans]
    assert names.count("env.task.Clustering#0") == 5
    assert names.count("env.task.FindGoalPosition#2") == 5
    env.step_batch(state, actions)  # no capture in progress: not counted
    assert record.evaluations[("Clustering", "membership")] == 5


def test_the_census_records_the_sprite_slots_of_a_renderers_launch(
        monkeypatch):
    from spriteworld_torch.ops import rasterize_cuda

    monkeypatch.setattr(profiling, "_driver", lambda: None)
    monkeypatch.setattr(rasterize_cuda.scene_raster, "launches", 0)
    monkeypatch.setattr(rasterize_cuda.scene_raster, "by_mode", {})
    monkeypatch.setattr(rasterize_cuda.scene_raster, "by_batch", {})
    with profiling.capture("render") as record:
        for _ in range(2):
            rasterize_cuda._count_launch(rasterize_cuda.scene_raster,
                                         "exact+lanczos", 2048, 12)
        profiling.count("lane_random", "keys", 40)
    census = record.census_table()
    assert census["scene_raster"] == {"exact+lanczos": {
        "launches": 2, "blocks": 0, "slots": [12]}}
    assert census["lane_random"] == {"keys": {"launches": 1, "blocks": 40}}


# ---------------------------------------------------------------------- #
# The readers of the task's nodes.

def _graph_record(nodes):
    """A runner step's GraphRecord whose spans open the task in the
    transition, under the fresh scene and in the render."""
    rec = profiling.GraphRecord("runner.step")
    for name, parent in (("runner.actions", -1), ("env.transition", -1),
                         ("env.task", 1), ("env.task.Clustering#0", 2),
                         ("env.task.FindGoalPosition#1", 2),
                         ("env.fresh", 1), ("env.task", 5),
                         ("env.task.Clustering#0", 6), ("env.render", -1),
                         ("env.task", 8), ("env.task.FindGoalPosition#1", 9),
                         ("runner.stack", -1)):
        rec.spans.append(profiling._GraphSpan(name, parent))
    rec.nodes = nodes
    return rec


def _context(ops, steps):
    from perfbench import check, devtrace, harness

    trace = devtrace.Trace(ops, [("rollout", 0, 10**9)], [],
                           {"linked": len(ops), "unlinked": 0})
    return harness.Context(trace=trace, steps=steps, calls=1, lanes=2,
                           config={}, tally=check.Tally(), host_step_ms=[],
                           layout=harness.Layout())


def _ops(nodes, durations, bad=()):
    """One replay of `nodes` a row of `durations` (ns), in launch order;
    the replays in `bad` launch their first kernel under another name."""
    from perfbench import devtrace

    ops, t = [], 0
    for r, row in enumerate(durations):
        for k, ((kind, _, name), dur) in enumerate(zip(nodes, row)):
            if r in bad and k == 0:
                name = "another"
            label = {"kernel": name, "memcpy": "Memcpy DtoD",
                     "memset": "Memset"}[kind]
            ops.append(devtrace.Op(label, t, t + dur, kind, 0,
                                   "cudaGraphLaunch"))
            t += dur + 500
    return ops


NODES = [("kernel", 0, "a"), ("kernel", 1, "b"), ("kernel", 3, "c"),
         ("kernel", 4, "d"), ("memcpy", 2, None), ("kernel", 7, "e"),
         ("kernel", 5, "f"), ("kernel", 10, "g"), ("kernel", 9, "h"),
         ("kernel", 8, "i"), ("kernel", 11, "j")]


def _read(name, ctx):
    from perfbench import harness

    return harness.Layout().reader(name).read(ctx)


def test_task_readers_charge_exactly_the_nodes_under_their_spans(
        monkeypatch):
    rec = _graph_record(NODES)
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    # Node k of each replay takes (k + 1) µs; the third replay does not fit
    # the map and counts for no span.
    durations = [[1000 * (k + 1) for k in range(len(NODES))]] * 3
    ctx = _context(_ops(NODES, durations, bad={2}), steps=4)
    # Under env.task: nodes 2 (c), 3 (d), 4 (memcpy), 5 (e), 7 (g), 8 (h).
    task = 2 * (3 + 4 + 5 + 6 + 8 + 9) * 1e-3 / 4
    clustering = 2 * (3 + 6) * 1e-3 / 4  # c and e
    assert _read("env_step.task_ms.rollout", ctx) == pytest.approx(task)
    assert _read("env_step.clustering_ms.rollout", ctx) \
        == pytest.approx(clustering)


def test_task_readers_give_none_without_their_nodes(monkeypatch):
    ctx = _context(_ops(NODES, [[1000] * len(NODES)]), steps=1)
    names = ("env_step.task_ms.rollout", "env_step.clustering_ms.rollout")
    monkeypatch.setattr(profiling, "graphs", lambda: [])
    assert [_read(n, ctx) for n in names] == [None, None]
    # A program that records no graphs at all.
    monkeypatch.delattr(profiling, "graphs")
    ctx = _context(_ops(NODES, [[1000] * len(NODES)]), steps=1)
    assert [_read(n, ctx) for n in names] == [None, None]
    # A map without a Clustering span (goal finding's, or the parent's).
    monkeypatch.undo()
    nodes = [("kernel", 0, "a"), ("kernel", 2, "c"), ("kernel", 11, "j")]
    rec = _graph_record(nodes)
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    ctx = _context(_ops(nodes, [[1000, 2000, 3000]]), steps=1)
    assert _read("env_step.task_ms.rollout", ctx) == pytest.approx(2e-3)
    assert _read("env_step.clustering_ms.rollout", ctx) is None
