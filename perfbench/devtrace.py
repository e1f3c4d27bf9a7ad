"""A device trace of a bounded slice of a run, and the host spans around it.

`Tracer.span(name)` marks a stretch of the benchmark's own host code (a
`torch.profiler.record_function` range named `perfbench.<name>`). Between
`Tracer.start()` and `Tracer.stop()` torch.profiler records the card's
operations (kernels, copies, fills; a CUDA graph's kernels one by one) and
the host's runtime calls; `Tracer.finish()` reads them into a `Trace` once
the window has closed. Outside the profiled slice a span costs nothing.

Each device operation is charged to the span in which the host launched
it: the operation's correlation id names its runtime call (a kernel launch,
a graph launch, a copy), whose host time lies in one span. `Trace.placed`
counts the operations so placed and those the trace left without a link,
which no span is charged with.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench."


@dataclasses.dataclass
class Op:
    """One device operation: times in ns on the profiler's clock."""

    name: str
    start: int
    end: int
    kind: str  # "kernel", "memcpy" or "memset"
    span: int = -1  # index into Trace.spans, -1 outside every span
    via: str = ""  # the runtime call that launched it, where known


@dataclasses.dataclass
class Trace:
    """The profiled slice: device operations sorted by start, the
    benchmark's host spans (name, start, end) sorted by start, the host's
    runtime calls (name, start, end) sorted by start, and how the
    operations were placed in spans."""

    ops: List[Op]
    spans: List[Tuple[str, int, int]]
    calls: List[Tuple[str, int, int]]
    placed: Dict[str, int]

    @property
    def start(self) -> int:
        return self.spans[0][1]

    @property
    def end(self) -> int:
        return self.spans[-1][2]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self, pattern: Optional[str] = None) -> List[Op]:
        return [o for o in self.ops if o.kind == "kernel"
                and (pattern is None or pattern in o.name)]

    def span_ops(self, name: str) -> List[Op]:
        return [o for o in self.ops
                if o.span >= 0 and self.spans[o.span][0] == name]

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def busy_intervals(self, ops: Optional[List[Op]] = None):
        """The union of the operations' intervals, clipped to the slice,
        as sorted disjoint (start, end) pairs."""
        if ops is None:
            if self._busy is None:
                self._busy = self.busy_intervals(self.ops)
            return self._busy
        out = []
        for o in sorted(ops, key=lambda o: o.start):
            s, e = max(o.start, self.start), min(o.end, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, ops: Optional[List[Op]] = None) -> float:
        return sum(e - s for s, e in self.busy_intervals(ops)) / 1e9

    def idle_ns(self, lo: int, hi: int) -> int:
        """ns of [lo, hi) in which no device operation ran."""
        covered = sum(max(0, min(e, hi) - max(s, lo))
                      for s, e in self.busy_intervals())
        return max(hi - lo, 0) - covered

    def idle_gaps(self):
        """[(start, end)] of the slice's stretches with no device
        operation running."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_activity(self, t: int) -> str:
        """What the host did at time t: the benchmark's span in progress
        and the runtime call in progress ("python" where none was)."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        span = (self.spans[i][0] if i >= 0 and self.spans[i][2] >= t
                else "outside spans")
        j = bisect.bisect_right(self._call_starts, t) - 1
        call = (self.calls[j][0] if j >= 0 and self.calls[j][2] >= t
                else "python")
        return f"{span}/{call}"

    def __post_init__(self):
        self._busy = None
        self._span_starts = [s[1] for s in self.spans]
        self._call_starts = [c[1] for c in self.calls]


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu")


def parse(events) -> Trace:
    """A Trace from torch.profiler's raw (kineto) events."""
    cpu = torch.autograd.DeviceType.CPU
    spans, runtime, ops_raw = [], [], []
    launches: Dict[int, Tuple[int, str]] = {}
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cpu:
            if name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], start, end))
            elif _is_runtime(name):
                runtime.append((name, start, end))
                launches[ev.correlation_id()] = (start, name)
            continue
        if ev.is_user_annotation() or name.startswith(PREFIX):
            continue
        ops_raw.append((name, start, end, ev.correlation_id()))
    spans.sort(key=lambda s: s[1])
    runtime.sort(key=lambda c: c[1])
    span_starts = [s[1] for s in spans]
    placed = {"linked": 0, "unlinked": 0}
    ops = []
    for name, start, end, corr in sorted(ops_raw, key=lambda o: o[1]):
        span, via = -1, ""
        if corr in launches:
            t, via = launches[corr]
            i = bisect.bisect_right(span_starts, t) - 1
            span = i if i >= 0 and spans[i][2] >= t else -1
        placed["linked" if via else "unlinked"] += 1
        ops.append(Op(name, start, end, _kind(name), span, via))
    return Trace(ops, spans, runtime, placed)


class Tracer:
    """Spans of the benchmark's host code, and the profiled slice."""

    def __init__(self):
        self._on = False
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self._on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    def start(self):
        """Start profiling."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._on = True

    def stop(self):
        """Wait for the device inside the last span ("sync"), so that the
        slice holds the work launched in it, and stop profiling."""
        with self.span("sync"):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self._on = False
        self._prof.stop()

    def finish(self) -> Optional[Trace]:
        """The profiled slice as a Trace (None where nothing was
        profiled); read once the window has closed."""
        if self.trace is None and getattr(self, "_prof", None) is not None:
            self.trace = parse(self._prof.profiler.kineto_results.events())
            self._prof = None
        return self.trace
