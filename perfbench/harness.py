"""One run of one cell of `BENCHMARK.json`, found by name.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel sits in files of its own, which `Layout` finds by the names in
`BENCHMARK.json`:

  perfbench/configs/<config>.json    the configuration as it is run
  perfbench/reference/<config>.py    its plain reference (`build`)
  perfbench/traffic/<mix>.json       the mix's parameters (`traffic.py`)
  perfbench/loops/<loop>.py          the loop a mix names (`Loop`, `check`)
  perfbench/metrics/<metric>.py      a per-layer metric's reader (`read`)
  perfbench/roofline/<kernel>.py     a kernel's least time

A configuration's file names the module whose `get_config(mode)` builds
it, the `overrides` laid over that (a value {"call": "module:name",
"kwargs": {...}} is built by that call), the `observation` that the loops
record and the reference renders, and in `holds` the attribute paths of
the built configuration that must equal its stated sizes.

A later cell, mix, metric or kernel count is new files and new entries of
`BENCHMARK.json`; no file here changes.

A run: the traffic loop builds the program and warms up every shape the cell
uses (set-up), then drives it for the window; with `trace`, a bounded
slice of calls follows under the profiler. Once the window has closed
the device's peak memory is read, the records of what the timed path
produced go to the host, the program's state is freed, and the plain
reference judges them (`check.py`).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import List, Optional

import torch

from perfbench import check, traffic
from perfbench.devtrace import Trace, Tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Top-level module names that must not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "spriteworld_tpu")
# The port's own CUDA kernels, by symbol name.
PORT_KERNELS = ("scene_raster", "strip_raster", "strip_vpass",
                "packed_raster", "lane_random")
BREAKDOWN_ENTRIES = 10


def _find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load(path: pathlib.Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Layout:
    """The benchmark's files under `root` (a checkout's root)."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "perfbench"

    def cell(self, name: str) -> dict:
        return _find(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _find(self.bench["configs"], name, "config")
        return json.loads((self.root / entry["file"]).read_text())

    def reference(self, config: str) -> pathlib.Path:
        return self.dir / "reference" / f"{config}.py"

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json")
                          .read_text())

    def loop(self, name: str):
        return _load(self.dir / "loops" / f"{name}.py", "perfbench_loop_")

    def reader(self, metric: str):
        return _load(self.dir / "metrics" / f"{metric}.py",
                     "perfbench_metric_")

    def roofline(self, kernel: str):
        return _load(self.dir / "roofline" / f"{kernel}.py",
                     "perfbench_roofline_")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that list the cell under `workloads`,
        which every per-layer entry has."""
        for m in self.bench["per_layer"]:
            if "workloads" not in m:
                raise KeyError(f"per-layer metric {m['name']!r} lists no "
                               "workloads")
        return [m for m in self.bench["per_layer"]
                if cell in m["workloads"]]


def _built(value):
    """An override's value: {"call": "module:name", "kwargs": {...}} is
    that call's result; a dict is built item by item."""
    if isinstance(value, dict) and "call" in value:
        module, name = value["call"].split(":")
        fn = getattr(importlib.import_module(module), name)
        return fn(**_built(value.get("kwargs", {})))
    if isinstance(value, dict):
        return {k: _built(v) for k, v in value.items()}
    return value


def _resolve(cfg, path: str):
    """The value at a dotted path of a built configuration (a key of a
    dict, else an attribute); a dict reads as its sorted keys, a tuple as
    a list."""
    value = cfg
    for part in path.split("."):
        value = value[part] if isinstance(value, dict) else getattr(
            value, part)
    if isinstance(value, dict):
        return sorted(value)
    return list(value) if isinstance(value, tuple) else value


def env_kwargs(config: dict) -> dict:
    """The Environment arguments of a configuration's file: its module's
    `get_config(mode)` with the file's `overrides`, held to the sizes the
    file states (`holds`: a key of the file, and the path whose value must
    equal it)."""
    mod = importlib.import_module(config["module"])
    cfg = mod.get_config(config["mode"])
    cfg.update(_built(config.get("overrides", {})))
    for key, path in config["holds"].items():
        found = _resolve(cfg, path)
        if found != config[key]:
            raise ValueError(f"{config['name']}: {path} is {found!r}, the "
                             f"configuration's file states {config[key]!r}")
    return cfg


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the profiled slice, the
    env steps, rollout calls and lanes in it, the configuration, the
    comparison's tally, the loop's host timings and the layout (for a
    kernel's roofline)."""

    trace: Trace
    steps: int
    calls: int
    lanes: int
    config: dict
    tally: check.Tally
    host_step_ms: List[float]
    layout: Layout

    def roofline(self, kernel: str):
        return self.layout.roofline(kernel)


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (its span and runtime call)."""
    ops = collections.Counter()
    for o in trace.ops:
        ops[o.name[:160]] += (o.end - o.start) / 1e9
    idle = collections.Counter()
    for s, e in trace.idle_gaps():
        idle[trace.host_activity((s + e) // 2)] += (e - s) / 1e9
    return {"device_ops": [[n, v] for n, v in
                           ops.most_common(BREAKDOWN_ENTRIES)],
            "idle_gaps": [[n, v] for n, v in
                          idle.most_common(BREAKDOWN_ENTRIES)]}


class ForbiddenModules(RuntimeError):
    pass


def run(layout: Layout, workload: str, seed: int, seconds: float,
        trace: bool, device="cuda", t_start: Optional[float] = None,
        stages: Optional[dict] = None):
    """One run; returns (result, info, rows): the result object, the
    earlier lines' information, and the compared numbers (name, value,
    limit). `t_start` is the process's start on `time.perf_counter`'s
    clock; `stages`, the set-up stages timed before this call."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = layout.cell(workload)
    config = layout.config(cell["config"])
    mix = layout.traffic(cell["traffic"])
    tracer = Tracer()
    observation = config["observation"]
    t_built = time.perf_counter()
    kwargs = env_kwargs(config)
    feed = traffic.build(layout, mix, kwargs, observation, device, seed,
                         tracer)
    stages = dict(stages or {}, to_harness_s=t_built - t_start)
    stages.update(feed.setup(seconds))
    setup_s = time.perf_counter() - t_start
    gc_before = [g["collections"] for g in gc.get_stats()]
    win = feed.window(seconds, trace)
    gc_window = [g["collections"] - b for g, b in
                 zip(gc.get_stats(), gc_before)]
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = feed.records()
    ctx_info = feed.trace_context() if trace else None
    feed.free()
    slice_ = tracer.finish()
    reference = check.reference_module(layout.reference(cell["config"]))
    t_check = time.perf_counter()
    tally = feed.check(rec, reference, observation)
    correct, rows = check.verdict(tally, config["limits"])
    info = dict(win["info"], setup_s=setup_s, setup_stages=stages,
                window_s=win["elapsed"], gc_collections=gc_window,
                answers_compared=tally.answers,
                check_s=time.perf_counter() - t_check,
                stand_in_dm_env=getattr(feed, "stand_in", False))
    values = dict(win["metrics"], setup_s=setup_s)
    metrics = {}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(tally.answers_off)}
    if not trace:
        for m in layout.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = Context(trace=slice_, steps=ctx_info["steps"],
                      calls=ctx_info["calls"], lanes=ctx_info["lanes"],
                      config=config, tally=tally,
                      host_step_ms=ctx_info.get("host_step_ms", []),
                      layout=layout)
        for m in layout.per_layer(workload):
            value = layout.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=slice_.busy_s(),
                           window_s=slice_.window_s)
        info["trace_ops"] = len(slice_.ops)
        info["trace_placed"] = slice_.placed
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = breakdown(slice_)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, info, rows
