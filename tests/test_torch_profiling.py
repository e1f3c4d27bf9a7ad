"""Profiling/debug helpers of the port (`spriteworld_torch.utils.profiling`),
mirroring tests/test_profiling.py."""

import json

import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from spriteworld_torch.utils import profiling


@pytest.fixture
def tracing():
    """Tracing on, with no spans recorded before; off and cleared after."""
    profiling.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


def test_step_timer_accumulates_across_chunks():
    t = profiling.StepTimer()
    x = torch.arange(8.0)
    for _ in range(3):
        t.start()
        y = torch.sin(x).sum()
        t.stop(100, sync_on=y)
    assert t.steps_per_sec > 0
    # 300 steps over a strictly positive elapsed time.
    assert t._steps == 300 and t._elapsed > 0


def test_annotate_names_a_range_in_the_trace(tmp_path, tracing):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("square"):
            y = torch.arange(4.0) * torch.arange(4.0)
    assert torch.equal(y, torch.arange(4.0) ** 2)
    assert any(e.key == "spriteworld.square" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "spriteworld.square"
               for e in events["traceEvents"])


def test_trace_writes_profile(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones((8, 8)).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_enable_debug_checks_flags_nan_and_inf():
    profiling.enable_debug_checks(nans=True, infs=False)
    try:
        with pytest.raises(FloatingPointError):
            torch.tensor(1.0) / 0.0 * 0.0
        torch.tensor(1.0) / 0.0  # an Inf passes with infs=False
    finally:
        profiling.enable_debug_checks(nans=False, infs=False)
    assert torch.isnan(torch.tensor(1.0) / 0.0 * 0.0)  # checks are off
    profiling.enable_debug_checks(nans=False, infs=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.tensor(1.0) / 0.0
    finally:
        profiling.enable_debug_checks(nans=False, infs=False)


def test_sync_takes_a_tensor_or_a_tree():
    profiling.sync(torch.tensor(3.0))
    profiling.sync({"a": torch.arange(6).reshape(2, 3)})
    profiling.sync({})


# ---------------------------------------------------------------------- #
# The recorder: spans, the node map of a capture, the census.

def test_an_off_span_is_the_shared_null_context_and_records_nothing(
        monkeypatch):
    profiling.clear()
    monkeypatch.setattr(torch.cuda, "Event", None)  # no event is made
    first = profiling.annotate("a")
    assert first is profiling.annotate("b", device=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("a"), profiling.annotate("b", device=True):
            torch.ones(3).sum()
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert not any(e.key.startswith(profiling.PREFIX)
                   for e in prof.key_averages())


def test_on_spans_nest_and_carry_parent_and_call_ids(tracing):
    with profiling.annotate("root"):
        with profiling.annotate("child"):
            with profiling.annotate("leaf"):
                pass
        with profiling.annotate("sibling"):
            pass
    with profiling.annotate("root"):
        pass
    s = profiling.spans()
    assert [(x.name, x.parent, x.call) for x in s] == [
        ("root", -1, 1), ("child", 0, 1), ("leaf", 1, 1),
        ("sibling", 0, 1), ("root", -1, 2)]
    assert [profiling.path(s, i) for i in range(3)] == [
        "root", "root/child", "root/child/leaf"]
    for x in s:
        assert x.start <= x.end and x.events is None
        if x.parent >= 0:
            p = s[x.parent]
            assert p.start <= x.start and x.end <= p.end
    assert s[3].start >= s[1].end  # siblings in order


def test_on_spans_match_their_profiler_ranges_on_one_clock(tracing):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with profiling.annotate("outer"):
                with profiling.annotate("inner"):
                    torch.ones(3).sum()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    seen, lead, lag = {}, [], []
    for x in profiling.spans():
        name = profiling.PREFIX + x.name
        i = seen[name] = seen.get(name, -1) + 1
        start, end = sorted(ranges[name])[i]
        # Inside its range (give or take the profiler's own conversion of
        # its clock), on the same clock: µs apart, not seconds.
        assert start - 20_000 <= x.start <= x.end <= end + 20_000
        lead.append(x.start - start)
        lag.append(end - x.end)
    assert sorted(lead)[len(lead) // 2] < 100_000
    assert sorted(lag)[len(lag) // 2] < 100_000


def test_annotate_pushes_no_nvtx_range(monkeypatch, tracing):
    def refuse(*args):
        raise AssertionError("an NVTX range was pushed")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    with profiling.annotate("on"):
        pass
    profiling.disable()
    with profiling.annotate("off"):
        pass
    assert [x.name for x in profiling.spans()] == ["on"]


def test_spans_beyond_the_cap_are_counted_not_kept(monkeypatch, tracing):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    for _ in range(5):
        with profiling.annotate("a"):
            pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2


def test_census_counts_launches_and_blocks_by_mode_on_the_cpu_twin(
        monkeypatch):
    from spriteworld_torch.ops import lane_random

    keys = lane_random.split(lane_random.key(5), 6)
    # No CUDA driver here: the capture keeps no node map, only the census.
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    with profiling.capture("draws") as record:
        lane_random.split(keys, 3)
        lane_random.uniform(keys, 2)
        lane_random.randint(keys, 5, 0, 9)
        lane_random.split_chain(keys, 4)
        lane_random.uniform(keys[:0], 2)  # no lanes: no launch
    assert record.nodes is None
    assert record.census == {("lane_random", "keys"): [1, 6 * 3],
                             ("lane_random", "uniform"): [1, 6 * 2],
                             ("lane_random", "randint"): [1, 4 * 6 * 5],
                             ("lane_random", "chain"): [1, 2 * 6 * 4]}
    assert record.census_table()["lane_random"]["randint"] == {
        "launches": 1, "blocks": 120}
    lane_random.split(keys, 3)  # no capture in progress: nothing counted
    assert sum(v[0] for v in record.census.values()) == 4


class _CapturedOnTheCpu(TorchDispatchMode):
    """Stands in for a CUDA stream capture on the CPU: each operator
    dispatched adds one kernel node to the graph, named after the
    operator, which the CUDA driver's stand-in (`driver`) reports as
    `utils.profiling` asks it."""

    def __init__(self):
        super().__init__()
        self.names = []

    @property
    def nodes(self):
        return len(self.names)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))

    def driver(self):
        def info(stream, status, graph_id, graph, deps, n_deps):
            status._obj.value = profiling._CAPTURE_ACTIVE
            graph._obj.value = 1
            return 0

        def nodes(graph, handles, n):
            if handles is not None:
                for k in range(min(n._obj.value, self.nodes)):
                    handles[k] = k + 1
            n._obj.value = self.nodes
            return 0

        def kind(handle, out):
            out._obj.value = 0  # a kernel
            return 0

        def name(handle):
            return self.names[handle - 1]

        return info, nodes, kind, name


def _small_goal_finding(device="cpu"):
    from spriteworld_torch.configs.cobra import goal_finding_new_position
    from spriteworld_torch.core import environment, renderers

    cfg = goal_finding_new_position.get_config("train")
    cfg["renderers"] = {"image": renderers.ImageRenderer(
        image_size=(16, 16), anti_aliasing=1, color_to_rgb="hsv")}
    return environment.Environment(**cfg, device=device)


def _captured_runner_step(monkeypatch, lanes=4):
    """The node map of one runner step captured under the stand-in."""
    from spriteworld_torch.parallel import runner as runner_lib

    fake = _CapturedOnTheCpu()
    monkeypatch.setattr(profiling, "_driver", fake.driver)
    monkeypatch.setattr(profiling, "_current_stream", lambda: 0)
    runner = runner_lib.ShardedRunner(_small_goal_finding(), lanes)
    state, _ = runner.reset(3)
    carry = runner_lib._Carry.like(state, runner.episode_returns,
                                   runner.action_key)
    with fake, profiling.capture("runner.step") as record:
        runner._step(carry, 1, True, None)
    return fake, record


def test_a_capture_charges_every_node_to_the_span_that_launched_it(
        monkeypatch):
    from perfbench import nodemap

    fake, record = _captured_runner_step(monkeypatch)
    assert record in profiling.graphs() and record.other_nodes == 0
    assert len(record.nodes) == fake.nodes > 0
    assert [name for _, _, name in record.nodes] == fake.names
    paths = [record.path(s) for _, s, _ in record.nodes]
    groups = {nodemap.group_of(p) for p in paths}
    assert groups == {"fresh", "transition", "render", "carry"}
    assert profiling.spans() == []  # tracing was off: no time spans
    names = {x.name for x in record.spans}
    assert {"runner.actions", "env.transition", "env.fresh", "env.task",
            "env.render", "runner.stack"} <= names
    # The fresh scene's sampler nodes, depth first.
    assert {"env.fresh.Shuffle#0", "env.fresh.ChainGenerators#1",
            "env.fresh.GenerateSprites#2", "env.fresh.SetMinus#3",
            "env.fresh.GenerateSprites#4"} <= names
    # Nodes charged in launch order: the groups come as the step runs.
    order = [nodemap.group_of(p) for p in paths]
    assert order[0] == "carry" and order[-1] == "carry"
    assert order.index("render") > order.index("fresh")
    # The draws of the capture are its census.
    draws = {m: v for (k, m), v in record.census.items()
             if k == "lane_random"}
    assert draws["keys"][0] > 0 and draws["randint"][1] % 4 == 0


class _Leaf:
    @profiling.node
    def sample_with_status(self, key):
        return key


class _Pair:
    def __init__(self):
        self.parts = (_Leaf(), _Leaf())

    @profiling.node
    def sample_with_status(self, key):
        return [p.sample_with_status(key) for p in self.parts]


def test_sampler_nodes_are_numbered_under_the_span_that_encloses_them(
        tracing):
    with profiling.annotate("env.fresh"):
        _Pair().sample_with_status(0)
        _Leaf().sample_with_status(0)
    with profiling.annotate("env.fresh"):  # a new scene counts anew
        _Leaf().sample_with_status(0)
    _Leaf().sample_with_status(0)  # no enclosing span: its class alone
    s = profiling.spans()
    assert [(x.name, x.parent) for x in s] == [
        ("env.fresh", -1), ("env.fresh._Pair#0", 0),
        ("env.fresh._Leaf#1", 1), ("env.fresh._Leaf#2", 1),
        ("env.fresh._Leaf#3", 0), ("env.fresh", -1),
        ("env.fresh._Leaf#0", 5), ("_Leaf", -1)]
    # Off, a node is the plain call.
    profiling.disable()
    assert _Pair().sample_with_status(7) == [7, 7]
    assert len(profiling.spans()) == 8


def test_tracing_leaves_the_step_as_it_was():
    from spriteworld_torch.parallel import ShardedRunner

    runs = []
    for on in (False, True):
        runner = ShardedRunner(_small_goal_finding(), 4)
        state, _ = runner.reset(11)
        if on:
            profiling.enable()
        try:
            runs.append(runner.rollout(state, 3, return_timesteps=True))
        finally:
            profiling.disable()
    names = {x.name for x in profiling.spans()}
    profiling.clear()
    assert {"runner.rollout", "runner.load", "runner.replay", "runner.read",
            "runner.clone", "env.fresh.SetMinus#3"} <= names
    (s0, m0, t0), (s1, m1, t1) = runs
    assert m0 == m1
    for a, b in ((s0.factors, s1.factors), (s0.key, s1.key),
                 (t0.observation["image"], t1.observation["image"])):
        assert torch.equal(a, b)


class _Event:
    """A CUDA event's stand-in: its time on the device, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, parent, call, start_ms, end_ms, device=None):
    s = profiling.Span(name, parent, call, int(start_ms * 1e6),
                       None if device is None else
                       (_Event(device[0]), _Event(device[1])))
    s.end = int(end_ms * 1e6)
    return s


def test_summary_gives_self_time_device_time_and_gaps():
    # Two adapter steps: the compiled step (its replay a device span) and
    # the fetch inside each; the card runs the replays at 1-4 and 6-8 ms.
    recs = [
        _span("adapter.step", -1, 1, 0.0, 5.0),
        _span("compiled.step", 0, 1, 0.5, 1.0),
        _span("compiled.replay", 1, 1, 0.6, 0.9, device=(1.0, 4.0)),
        _span("adapter.fetch", 0, 1, 1.0, 4.5),
        _span("adapter.step", -1, 2, 5.0, 9.0),
        _span("compiled.step", 4, 2, 5.2, 5.6),
        _span("compiled.replay", 5, 2, 5.3, 5.5, device=(6.0, 8.0)),
        _span("adapter.fetch", 4, 2, 5.6, 8.4),
    ]
    s = profiling.summary(recs)
    step = s["adapter.step"]
    assert step["count"] == 2 and step["ms"] == pytest.approx(4.5)
    # 5 - 0.5 - 3.5 and 4 - 0.4 - 2.8: the median self time is 0.9.
    assert step["self_ms"] == pytest.approx(0.9)
    replay = s["adapter.step/compiled.step/compiled.replay"]
    assert replay["device_ms"] == pytest.approx(2.5)
    assert replay["device_ms_sum"] == pytest.approx(5.0)
    assert replay["gap_ms"] == pytest.approx(2.0)  # 4 ms to 6 ms
    assert "device_ms" not in s["adapter.step/adapter.fetch"]
    whole = s[""]
    assert whole["wall_ms"] == pytest.approx(9.0) and whole["spans"] == 8
    # The single cells' idle share: 1 - 5 ms of replays over 9 ms.
    assert 100 * (1 - replay["device_ms_sum"] / whole["wall_ms"]) \
        == pytest.approx(100 * 4 / 9)
    # A span without children is all self time; one without events has
    # no device keys.
    assert s["adapter.step/adapter.fetch"] == {
        "count": 2, "ms": pytest.approx(3.15),
        "self_ms": pytest.approx(3.15)}


# ---------------------------------------------------------------------- #
# The benchmark's readers of the node map and the census.

def _graph_record(nodes, census=None):
    """A GraphRecord of a runner step: spans and [(kind, span, name)]
    nodes."""
    rec = profiling.GraphRecord("runner.step")
    for name, parent in (("runner.actions", -1), ("env.transition", -1),
                         ("env.fresh", 1), ("env.fresh.SetMinus#0", 2),
                         ("env.render", -1), ("runner.stack", -1),
                         ("other", -1)):
        rec.spans.append(profiling._GraphSpan(name, parent))
    rec.nodes = nodes
    rec.census = census or {}
    return rec


def _context(ops, steps, tally=None, lanes=2):
    from perfbench import check, devtrace, harness

    trace = devtrace.Trace(ops, [("rollout", 0, 10**9)], [],
                           {"linked": len(ops), "unlinked": 0})
    return harness.Context(trace=trace, steps=steps, calls=1, lanes=lanes,
                           config={}, tally=tally or check.Tally(),
                           host_step_ms=[], layout=harness.Layout())


def _op(kind, start, dur, via="cudaGraphLaunch", name="k"):
    from perfbench import devtrace

    name = {"kernel": name, "memcpy": "Memcpy DtoD", "memset": "Memset"}[kind]
    return devtrace.Op(name, start, start + dur, kind, 0, via)


def test_node_metrics_add_up_to_the_replays_and_count_unplaced(
        monkeypatch, capsys):
    from perfbench import harness

    nodes = [("kernel", 0, "k"), ("kernel", 1, "k"), ("kernel", 3, "k"),
             ("memcpy", 2, None), ("kernel", 4, "k"), ("kernel", 5, "k"),
             ("kernel", 6, "k"), ("memset", -1, None)]
    rec = _graph_record(nodes)
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    ops, t = [], 0
    for replay in range(3):
        kinds = [k for k, _, _ in nodes]
        if replay == 2:  # a replay the map does not fit: unplaced whole
            kinds = kinds[::-1]
        for k in kinds:
            ops.append(_op(k, t, 1000))
            t += 1500
    ops.append(_op("kernel", t, 7000, via="cudaLaunchKernel"))  # not replayed
    ctx = _context(ops, steps=3)
    layout = harness.Layout()
    got = {m: layout.reader(m).read(ctx) for m in (
        "env_step.fresh_ms.rollout", "env_step.transition_ms.rollout",
        "env_step.render_ms.rollout", "runner.carry_ms.rollout")}
    # Two placed replays of 1 µs a node over three steps.
    per = 2 * 1e-3 / 3
    assert got == pytest.approx({
        "env_step.fresh_ms.rollout": 2 * per,
        "env_step.transition_ms.rollout": per,
        "env_step.render_ms.rollout": per,
        "runner.carry_ms.rollout": 2 * per})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    info = line["node_map"]
    assert info["unplaced_nodes"] == 2  # span "other" and no span
    assert info["unplaced_ops"] == 2 * 2 + 8
    total = info["ms_a_step"]["total"]
    assert total == pytest.approx(24 * 1e-3 / 3)
    assert sum(got.values()) + info["ms_a_step"]["unplaced"] \
        == pytest.approx(total)


def test_a_replay_whose_kernel_names_differ_from_the_nodes_is_unplaced(
        monkeypatch, capsys):
    from perfbench import harness

    nodes = [("kernel", 0, "a"), ("memcpy", 2, None), ("kernel", 4, "b"),
             ("kernel", 5, "c")]
    rec = _graph_record(nodes)
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    replays = [["a", "", "b", "c"],   # fits
               ["a", "", "c", "b"],   # the same kinds, two kernels swapped
               ["a", "", "b", "c"]]   # fits
    ops, t = [], 0
    for names in replays:
        for (kind, _, _), name in zip(nodes, names):
            ops.append(_op(kind, t, 1000, name=name))
            t += 1500
    read = harness.Layout().reader("env_step.render_ms.rollout").read
    assert read(_context(ops, steps=3)) == pytest.approx(2 * 1e-3 / 3)
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    info = info["node_map"]
    assert info["unplaced_replays"] == 1 and info["unplaced_ops"] == 4
    assert info["first_mismatch"] == [6, "('kernel', 'c')", "('kernel', 'b')"]
    assert info["ms_a_step"]["unplaced"] == pytest.approx(4 * 1e-3 / 3)
    # A kernel node the driver could not name matches no operation.
    rec.nodes = [("kernel", 0, "a"), ("memcpy", 2, None), ("kernel", 4, None),
                 ("kernel", 5, "c")]
    assert read(_context(ops, steps=3)) == 0.0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["node_map"]["unnamed_kernels"] == 1
    assert info["node_map"]["unplaced_replays"] == 3


def test_node_names_are_demangled_as_the_profiler_names_kernels():
    from perfbench import nodemap

    assert nodemap.demangle("_ZN2at6native6kernelEv") \
        == "at::native::kernel()"
    assert nodemap.demangle("_ZN2at6native6kernelILi4EEEvPf") \
        == "void at::native::kernel<4>(float*)"
    # A name that is not mangled C++ (a C kernel's, a Triton kernel's).
    assert nodemap.demangle("scene_raster_kernel") == "scene_raster_kernel"


def test_readers_find_nothing_without_a_node_map(monkeypatch):
    from perfbench import harness

    ctx = _context([_op("kernel", 0, 1000)], steps=1)
    layout = harness.Layout()
    names = ("env_step.fresh_ms.rollout", "runner.carry_ms.rollout",
             "lane_random.useful_blocks.rollout")
    monkeypatch.setattr(profiling, "graphs", lambda: [])
    assert [layout.reader(m).read(ctx) for m in names] == [None] * 3
    # A program that records no graphs at all (the parent's).
    monkeypatch.delattr(profiling, "graphs")
    ctx = _context([_op("kernel", 0, 1000)], steps=1)
    assert [layout.reader(m).read(ctx) for m in names] == [None] * 3


def test_useful_blocks_is_the_needed_share_of_the_census(monkeypatch):
    from perfbench import check, harness

    rec = _graph_record([("kernel", 0, "k")], census={
        ("lane_random", "keys"): [3, 3000],
        ("lane_random", "randint"): [1, 4000],
        ("scene_raster", "exact+lanczos"): [1, 0]})
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    tally = check.Tally(blocks=400, lane_steps=100)
    read = harness.Layout().reader("lane_random.useful_blocks.rollout").read
    # 4 blocks a lane step x 500 lanes + the action key's 2, of 7,000.
    assert read(_context([], 1, tally, lanes=500)) \
        == pytest.approx(100 * 2002 / 7000)
    # A step that computes only what it needs reads 100%, never more.
    rec.census = {("lane_random", "keys"): [1, 2002]}
    assert read(_context([], 1, tally, lanes=500)) == pytest.approx(100.0)
