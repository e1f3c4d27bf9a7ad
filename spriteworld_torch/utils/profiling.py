"""Tracing, profiling and numeric-debug helpers.

Counterpart of `spriteworld_tpu/utils/profiling.py`, on torch:

  * `trace(path)` — a `torch.profiler` trace of the enclosed region (host
    operators, and the card's kernels where there is one), written as a
    Chrome trace under `path`.
  * `annotate(name, device=False)` — a span of the port's one recorder.
    Tracing is off by default, and an off span is one shared null context:
    it reads one global and does nothing else. `enable()` and `disable()`
    switch tracing. An on span records its name, its parent span, its call
    (an id shared by every span under one root: one `rollout()` call, one
    adapter `step()` or `reset()`) and its start and end in ns on
    `time.time_ns`'s clock, which is the clock torch.profiler stamps its
    events with. While a torch.profiler session is active it is also a
    `record_function` range named `spriteworld.<name>`. A `device` span
    also records a pair of timing CUDA events around what it launched
    (a graph replay). Spans stay in memory, at most `SPAN_CAP`, until
    `clear()`; `spans()` and `summary()` read them once the work is done.
    `node` decorates a scene sampler's node with its span, numbered under
    the span that encloses the sampler (`env.fresh.<Class>#<i>`).
  * `capture(name)` — what a `StepGraph` records of the graph it captures
    (a `GraphRecord`, kept in `graphs()`): the graph's device nodes in
    capture order, each with the innermost span open when it was launched
    and a kernel's function name (the node map), and the census of the
    port's kernels launched into it. A graph captured from one stream
    replays its nodes in capture order, so the k-th device operation of a
    replay is node k, which the names let a reader check: a profiler's
    trace of replays is charged to spans through it. Spans are recorded
    into the capture whether tracing is on or not, because a replay runs
    no host code and the capture, at set-up, is the one chance to see
    them; a replay costs nothing more.
  * `count()` — the port's kernel wrappers count each launch and its
    threefry blocks by kernel and mode into the census of the capture in
    progress, and a renderer's kernels the sprite slots of its scenes; a
    kernel that counts on the card (the scene kernel's live units) leaves
    a reading there, which the census reads when it is taken.
  * `reading(name, fn)` — a counter that a kernel keeps on the card,
    which `summary()` reads (`fn()`) when it is taken, never on the step
    path.
  * `evaluation` — decorates a task's method (`reward`, `success`,
    `valid`, `membership`), and with `kind="action"` an action space's
    `step`: each call during a capture counts into its census by class and
    method, so the census says how many times a step evaluates each task
    and steps its action space.
  * `route()` — a scene sampler that can take one of several routes
    (`GenerateSprites`: the kernel's scene mode or its plain body) counts
    each evaluation during a capture into its census by class and route.
  * `task_route()` — a task evaluation (`core.tasks.Evaluator`: one
    launch of the task kernel, or the task's own methods) counts its route
    during a capture into the census by the root task's class.
  * `enable_debug_checks()` — raises FloatingPointError where an operation
    returns a NaN or an Inf, while enabled (a `TorchDispatchMode`).
  * `sync(value)` — waits for the card's work behind a tensor; a no-op for
    CPU tensors.
  * `StepTimer` — env-steps/s across rollout chunks, synchronising before
    it reads the clock.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The prefix of a span's torch.profiler range.
PREFIX = "spriteworld."
# The most spans kept between two `clear()` calls; later ones are counted
# in `dropped()` and not kept. A 10 s window of single steps records
# about 40,000.
SPAN_CAP = 1 << 17
# The most graph records kept (the oldest go first).
GRAPH_CAP = 64

_NULL = contextlib.nullcontext()
# The counters of `reading`, by name.
_READINGS: Dict[str, Callable[[], object]] = {}
# Tracing switched on by `enable()`.
_on = False
# The GraphRecord of the capture in progress, else None.
_capture: Optional["GraphRecord"] = None
# `_on or _capture is not None`: the one global an off span reads.
_live = False


class Span:
    """One recorded span: times in ns on `time.time_ns`'s clock; `parent`
    an index into `spans()` (-1 for a root); `events`, the device span's
    pair of CUDA events, else None; `node`, whether a sampler node's
    (`node`), and `nodes`, the node spans opened under it so far."""

    __slots__ = ("name", "parent", "call", "start", "end", "events", "node",
                 "nodes")

    def __init__(self, name: str, parent: int, call: int, start: int,
                 events, node: bool = False):
        self.name, self.parent, self.call = name, parent, call
        self.start, self.end = start, start
        self.events, self.node, self.nodes = events, node, 0

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6

    def device_ms(self) -> Optional[float]:
        """ms on the device between the span's events (waits for the
        second); None for a span without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class _Open:
    """What records spans: `spans`, each with `name`, `parent`, `node` and
    `nodes`, and `stack`, the indices of the open ones, innermost last."""

    spans: list
    stack: List[int]

    def named(self, name: str, node: bool) -> str:
        """The name of a span about to open: a node's (`node`, `name` its
        class) is `<root>.<class>#<i>`, root the innermost open span that
        is not a node's and i the nodes opened under it so far, depth
        first; else `name`."""
        if not node:
            return name
        for i in reversed(self.stack):
            root = self.spans[i]
            if not root.node:
                root.nodes += 1
                return f"{root.name}.{name}#{root.nodes - 1}"
        return name


class _Recorder(_Open):
    """The spans recorded while tracing is on."""

    def __init__(self):
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.calls = 0
        self.dropped = 0

    def enter(self, name: str, device: bool, node: bool):
        """The new span's index and its profiler range (or None)."""
        if len(self.spans) >= SPAN_CAP:
            self.dropped += 1
            return -1, None
        name = self.named(name, node)
        parent = self.stack[-1] if self.stack else -1
        if parent < 0:
            self.calls += 1
        call = self.spans[parent].call if parent >= 0 else self.calls
        rng = None
        if torch.autograd._profiler_enabled():
            rng = torch.profiler.record_function(PREFIX + name)
            rng.__enter__()
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        span = Span(name, parent, call, time.time_ns(), events, node)
        if events is not None:
            events[0].record()
        self.stack.append(len(self.spans))
        self.spans.append(span)
        return self.stack[-1], rng

    def exit(self, index: int, rng):
        if index < 0:
            return
        span = self.spans[index]
        if span.events is not None:
            span.events[1].record()
        span.end = time.time_ns()
        if rng is not None:
            rng.__exit__(None, None, None)
        self.stack.pop()


_REC = _Recorder()
_GRAPHS: collections.deque = collections.deque(maxlen=GRAPH_CAP)


class _Span:
    """An on span (see `annotate`)."""

    __slots__ = ("name", "device", "node", "_where", "_rec", "_index",
                 "_rng")

    def __init__(self, name: str, device: bool, node: bool = False):
        self.name, self.device, self.node = name, device, node

    def __enter__(self):
        self._where = _capture
        if self._where is not None:
            self._where._enter(self.name, self.node)
        else:
            self._rec = _REC
            self._index, self._rng = _REC.enter(self.name, self.device,
                                                self.node)
        return self

    def __exit__(self, *exc):
        if self._where is not None:
            self._where._exit()
        else:
            self._rec.exit(self._index, self._rng)
        return False


def annotate(name: str, device: bool = False):
    """A span named `name` around the enclosed block (see the module's
    docstring): the shared null context while tracing is off."""
    if not _live:
        return _NULL
    return _Span(name, device)


def node(sample_with_status):
    """Decorates a scene sampler node's `sample_with_status(self, key)` (a
    generator's or a rejection node's) with its span,
    `<root>.<Class>#<i>` (`_Open.named`): `env.fresh.<Class>#<i>` under
    the fresh scene's span."""

    @functools.wraps(sample_with_status)
    def sample(self, key):
        if not _live:
            return sample_with_status(self, key)
        with _Span(type(self).__name__, False, node=True):
            return sample_with_status(self, key)

    return sample


def _set(on: bool):
    global _on, _live
    _on = on
    _live = on or _capture is not None


def enable() -> None:
    """Record spans from now on."""
    _set(True)


def disable() -> None:
    """Stop recording spans (those recorded stay until `clear()`)."""
    _set(False)


def clear() -> None:
    """Forget the recorded spans (not the graph records)."""
    global _REC
    _REC = _Recorder()


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return _REC.spans


def dropped() -> int:
    """Spans not kept since the last `clear()`: beyond SPAN_CAP."""
    return _REC.dropped


def path(records, i: int) -> str:
    """"root/.../name" of record i of `records`, each with `name` and
    `parent` (a Span, or a GraphRecord's span)."""
    names = []
    while i >= 0:
        names.append(records[i].name)
        i = records[i].parent
    return "/".join(reversed(names))


def _median(values):
    return statistics.median(values) if values else None


def summary(records: Optional[List[Span]] = None) -> dict:
    """The recorded spans by path ("root/.../name"): {path: {"count",
    "ms" (the median host ms), "self_ms" (the median host ms less its children's),
    "device_ms" (the median ms between its events), "device_ms_sum",
    "gap_ms" (the mean device ms from one such span's end event to the
    next one's start event)}}, device keys for device spans only; and
    under "" the whole: {"wall_ms" from the first root's start to the
    last root's end, "spans", "dropped", "readings": {name: the value of
    each `reading`}}. Waits for the events and reads the card."""
    records = spans() if records is None else records
    kids = [0] * len(records)
    for s in records:
        if s.parent >= 0:
            kids[s.parent] += s.end - s.start
    by_path: Dict[str, List[int]] = {}
    roots = []
    for i, s in enumerate(records):
        by_path.setdefault(path(records, i), []).append(i)
        if s.parent < 0:
            roots.append(s)
    out = {}
    for p, idx in by_path.items():
        group = [records[i] for i in idx]
        row = {"count": len(group), "ms": _median([s.ms for s in group]),
               "self_ms": _median([records[i].ms - kids[i] / 1e6
                                   for i in idx])}
        timed = [s for s in group if s.events is not None]
        if timed:
            dev = [s.device_ms() for s in timed]
            gaps = [a.events[1].elapsed_time(b.events[0])
                    for a, b in zip(timed, timed[1:])]
            row.update(device_ms=_median(dev), device_ms_sum=sum(dev),
                       gap_ms=sum(gaps) / len(gaps) if gaps else None)
        out[p] = row
    out[""] = {"wall_ms": ((roots[-1].end - roots[0].start) / 1e6
                           if roots else None),
               "spans": len(records), "dropped": dropped(),
               "readings": {n: fn() for n, fn in _READINGS.items()}}
    return out


def reading(name: str, fn: Callable[[], object]) -> None:
    """Registers the counter `name` that a kernel keeps on the card:
    `summary()` reports fn() under "" → "readings"."""
    _READINGS[name] = fn


# ---------------------------------------------------------------------- #
# The node map of a captured graph.

# CUgraphNodeType values of the nodes a replay runs on the device.
_DEVICE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


class _KernelParams(ctypes.Structure):
    """The driver's CUDA_KERNEL_NODE_PARAMS_v2."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _driver():
    """(capture_info, graph_nodes, node_kind, kernel_name) from the CUDA
    driver: cuStreamGetCaptureInfo_v2, cuGraphGetNodes and
    cuGraphNodeGetType, typed, and a function giving a kernel node's
    function name (None where the driver cannot say); None where there is
    no driver."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        info = lib.cuStreamGetCaptureInfo_v2
        nodes = lib.cuGraphGetNodes
        kind = lib.cuGraphNodeGetType
    except (OSError, AttributeError):
        return None
    p = ctypes.POINTER
    info.argtypes = [ctypes.c_void_p, p(ctypes.c_int), p(ctypes.c_uint64),
                     p(ctypes.c_void_p), p(ctypes.c_void_p),
                     p(ctypes.c_size_t)]
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, p(ctypes.c_size_t)]
    kind.argtypes = [ctypes.c_void_p, p(ctypes.c_int)]
    for fn in (info, nodes, kind):
        fn.restype = ctypes.c_int
    return info, nodes, kind, _kernel_name_of(lib)


def _kernel_name_of(lib):
    """A kernel node's function name, as the driver gives it (mangled),
    from cuGraphKernelNodeGetParams_v2 and cuFuncGetName (or
    cuKernelGetName, where the node holds a CUkernel); None throughout on
    a driver without them (before CUDA 12.3)."""
    try:
        params_of = lib.cuGraphKernelNodeGetParams_v2
        func_name, kernel_name = lib.cuFuncGetName, lib.cuKernelGetName
    except AttributeError:
        return lambda handle: None
    params_of.argtypes = [ctypes.c_void_p, ctypes.POINTER(_KernelParams)]
    for fn in (func_name, kernel_name):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    for fn in (params_of, func_name, kernel_name):
        fn.restype = ctypes.c_int

    def name(handle) -> Optional[str]:
        params, out = _KernelParams(), ctypes.c_char_p()
        if params_of(handle, ctypes.byref(params)):
            return None
        if params.func:
            err = func_name(ctypes.byref(out), params.func)
        elif params.kern:
            err = kernel_name(ctypes.byref(out), params.kern)
        else:
            return None
        return None if err or not out.value else out.value.decode()

    return name


def _current_stream() -> int:
    """The handle of the current CUDA stream (the capture's)."""
    return torch.cuda.current_stream().cuda_stream


class _GraphSpan:
    __slots__ = ("name", "parent", "node", "nodes")

    def __init__(self, name: str, parent: int, node: bool = False):
        self.name, self.parent, self.node, self.nodes = name, parent, node, 0


class GraphRecord(_Open):
    """What a capture recorded of its graph.

    `name`: the graph's (the capturing `StepGraph`'s). `spans`: the spans
    opened during the capture, each with `name` and `parent` (an index,
    -1 for none). `nodes`: [(kind, span, function)] of the graph's device
    nodes in the driver's order, which is the capture's: kind "kernel",
    "memcpy" or "memset"; span the innermost span open when the node was
    launched (-1 for none); function a kernel's name as the driver gives
    it (mangled; None for a copy or a fill, or where the driver cannot
    say). A graph captured from one stream replays its nodes in that
    order, which a reader checks against a trace by these names. `nodes`
    is None where the CUDA driver could not be asked. `other_nodes`:
    nodes that run nothing on the device (empty, event). `census`:
    {(kernel, mode): [launches, blocks]} of the port's kernels launched
    into the graph (`count`): one replay's work, without a device read;
    `slots`: {(kernel, mode): {sprite slots a scene}} where the wrapper
    gave them; `evaluations`: {(task class, method): calls} (`evaluation`);
    `actions`: {(action space class, method): calls} (`evaluation` with
    `kind="action"`); `routes`: {(sampler class, route): calls}
    (`route`); `task_routes`: {(task class, route): calls}
    (`task_route`); `readings`: {(kernel, mode): fn} of the kernels that
    count on the card, `fn()` the last replay's count (`count`).
    """

    def __init__(self, name: str):
        self.name = name
        self.spans: List[_GraphSpan] = []
        self.stack: List[int] = []
        self.nodes: Optional[List[Tuple[str, int, Optional[str]]]] = None
        self.other_nodes = 0
        self.census: Dict[Tuple[str, str], List[int]] = {}
        self.slots: Dict[Tuple[str, str], set] = {}
        self.evaluations: Dict[Tuple[str, str], int] = {}
        self.actions: Dict[Tuple[str, str], int] = {}
        self.routes: Dict[Tuple[str, str], int] = {}
        self.task_routes: Dict[Tuple[str, str], int] = {}
        self.readings: Dict[Tuple[str, str], Callable[[], object]] = {}
        self._marks: List[Tuple[int, int]] = []  # (nodes so far, span)
        self._graph = None
        self._failed = False

    def path(self, span: int) -> str:
        return path(self.spans, span)

    def _count_nodes(self) -> Optional[int]:
        drv = None if self._failed else _driver()
        if drv is None:
            self._failed = True
            return None
        info, get = drv[:2]
        if self._graph is None:
            status, graph = ctypes.c_int(), ctypes.c_void_p()
            err = info(_current_stream(), ctypes.byref(status), None,
                       ctypes.byref(graph), None, None)
            if err or status.value != _CAPTURE_ACTIVE:
                self._failed = True
                return None
            self._graph = graph
        n = ctypes.c_size_t(0)
        if get(self._graph, None, ctypes.byref(n)):
            self._failed = True
            return None
        return n.value

    def _mark(self):
        n = self._count_nodes()
        if n is not None:
            self._marks.append((n, self.stack[-1] if self.stack else -1))

    def _enter(self, name: str, node: bool):
        self.spans.append(_GraphSpan(
            self.named(name, node), self.stack[-1] if self.stack else -1,
            node))
        self.stack.append(len(self.spans) - 1)
        self._mark()

    def _exit(self):
        self.stack.pop()
        self._mark()

    def _finish(self):
        """Reads the graph's nodes (still inside the capture) and charges
        each to the span in effect when it was added."""
        n = self._count_nodes()
        if n is None:
            return
        _, get, kind_of, kernel_name = _driver()
        handles = (ctypes.c_void_p * max(n, 1))()
        got = ctypes.c_size_t(n)
        if get(self._graph, handles, ctypes.byref(got)):
            return
        nodes, mark, span = [], 0, -1
        kind = ctypes.c_int()
        for k in range(got.value):
            while mark < len(self._marks) and self._marks[mark][0] <= k:
                span = self._marks[mark][1]
                mark += 1
            if kind_of(handles[k], ctypes.byref(kind)):
                return
            if kind.value not in _DEVICE_KINDS:
                self.other_nodes += 1
                continue
            what = _DEVICE_KINDS[kind.value]
            nodes.append((what, span, kernel_name(handles[k])
                          if what == "kernel" else None))
        self.nodes = nodes
        self._graph = None

    def census_table(self) -> Dict[str, Dict[str, dict]]:
        """{kernel: {mode: {"launches", "blocks"[, "slots"][,
        "live_units"]}}} of one replay, "slots" the sorted sprite slots of
        its scenes where counted, "live_units" [live, all] where the kernel
        counts them on the card (read now: the last replay's),
        {"task.<class>": {method: {"evaluations"}}},
        {"action.<class>": {method: {"evaluations"}}},
        {"generator.<class>": {route: {"evaluations"}}} and
        {"task_route.<class>": {route: {"evaluations"}}}."""
        out: Dict[str, Dict[str, dict]] = {}
        for (kernel, mode), (launches, blocks) in sorted(
                self.census.items()):
            row = {"launches": launches, "blocks": blocks}
            if (kernel, mode) in self.slots:
                row["slots"] = sorted(self.slots[(kernel, mode)])
            if (kernel, mode) in self.readings:
                row["live_units"] = list(self.readings[(kernel, mode)]())
            out.setdefault(kernel, {})[mode] = row
        for (cls, method), n in sorted(self.evaluations.items()):
            out.setdefault(f"task.{cls}", {})[method] = {"evaluations": n}
        for (cls, method), n in sorted(self.actions.items()):
            out.setdefault(f"action.{cls}", {})[method] = {"evaluations": n}
        for (cls, name), n in sorted(self.routes.items()):
            out.setdefault(f"generator.{cls}", {})[name] = {"evaluations": n}
        for (cls, name), n in sorted(self.task_routes.items()):
            out.setdefault(f"task_route.{cls}", {})[name] = {
                "evaluations": n}
        return out


@contextlib.contextmanager
def capture(name: str):
    """Records the graph that the enclosed block captures (inside
    `torch.cuda.graph`, on its stream): yields its `GraphRecord`, which
    joins `graphs()` once the block has run. Spans opened in the block
    are recorded into it, whether tracing is on or not."""
    global _capture, _live
    rec = GraphRecord(name)
    _capture, _live = rec, True
    try:
        rec._mark()
        yield rec
        rec._finish()
    finally:
        _capture, _live = None, _on
    _GRAPHS.append(rec)


def graphs() -> List[GraphRecord]:
    """The graph records kept, oldest first."""
    return list(_GRAPHS)


def count(kernel: str, mode: str, blocks: int = 0,
          slots: Optional[int] = None,
          reading: Optional[Callable[[], object]] = None) -> None:
    """One launch of `kernel` in `mode` computing `blocks` threefry blocks
    (over scenes of `slots` sprite slots, where given), into the census of
    the capture in progress, if any, with the `reading` of what the launch
    counts on the card (the last such launch's)."""
    if _capture is None:
        return
    entry = _capture.census.setdefault((kernel, mode), [0, 0])
    entry[0] += 1
    entry[1] += blocks
    if slots is not None:
        _capture.slots.setdefault((kernel, mode), set()).add(int(slots))
    if reading is not None:
        _capture.readings[(kernel, mode)] = reading


def evaluation(method=None, *, kind: str = "task"):
    """Decorates a task's method (`kind` "task") or an action space's
    (`kind` "action"): a call while a graph is being captured counts one
    evaluation of (the object's class, the method's name) into the
    capture's census (`GraphRecord.evaluations` or `.actions`). Off a
    capture it reads one global."""
    table = {"task": "evaluations", "action": "actions"}[kind]
    if method is None:
        return functools.partial(evaluation, kind=kind)

    @functools.wraps(method)
    def evaluate(self, *args, **kwargs):
        if _capture is not None:
            counts = getattr(_capture, table)
            key = (type(self).__name__, method.__name__)
            counts[key] = counts.get(key, 0) + 1
        return method(self, *args, **kwargs)

    return evaluate


def route(sampler: str, name: str) -> None:
    """One evaluation of the scene sampler class `sampler` by its route
    `name`, into the census of the capture in progress, if any."""
    if _capture is not None:
        key = (sampler, name)
        _capture.routes[key] = _capture.routes.get(key, 0) + 1


def task_route(task: str, name: str) -> None:
    """One evaluation of a task tree whose root is of class `task` by its
    route `name`, into the census of the capture in progress, if any."""
    if _capture is not None:
        key = (task, name)
        _capture.task_routes[key] = _capture.task_routes.get(key, 0) + 1


@contextlib.contextmanager
def trace(path: str):
    """Profile the enclosed region; writes `path`/trace.json (Chrome
    format). Yields the `torch.profiler.profile` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def _leaves(value):
    if isinstance(value, dict):
        return [x for v in value.values() for x in _leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    return [value] if isinstance(value, torch.Tensor) else []


class _DebugChecks(TorchDispatchMode):
    """Raises FloatingPointError on a NaN (and/or Inf) floating output."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if not t.is_floating_point():
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


# The mode `enable_debug_checks` entered, as JAX's jax_debug_nans/infs flags
# are one setting of the process.
_ACTIVE = []


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    """Check every operation's floating outputs for NaN/Inf from now on;
    `enable_debug_checks(False, False)` turns the checks off. Each check
    reads the result on the host, so it syncs with the card."""
    while _ACTIVE:
        _ACTIVE.pop().__exit__(None, None, None)
    if nans or infs:
        mode = _DebugChecks(bool(nans), bool(infs))
        mode.__enter__()
        _ACTIVE.append(mode)


def sync(value) -> None:
    """Wait for the card's work behind the first tensor in `value` (a
    tensor, or a dict/list/tuple of them); nothing for CPU tensors."""
    leaves = _leaves(value)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class StepTimer:
    """Wall-clock env-steps/s measurement across rollout chunks."""

    def __init__(self):
        self._steps = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, num_steps: int, sync_on=None) -> None:
        if sync_on is not None:
            sync(sync_on)
        self._elapsed += time.perf_counter() - self._t0
        self._steps += int(num_steps)
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self._steps / self._elapsed if self._elapsed else 0.0
