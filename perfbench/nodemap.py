"""The rollout cells' node map: the runner graph's replayed operations in
the profiled slice, charged to the port's spans that launched them at
capture.

At each capture `spriteworld_torch.utils.profiling` records the graph's
device nodes in capture order, each with the innermost port span open when
it was launched and a kernel's function name (`GraphRecord.nodes`). A
graph captured from one stream replays its nodes in that order, so the
operations that the slice's `rollout` spans launched through
`cudaGraphLaunch`, in start order, fall into replays of `len(nodes)`
operations, the k-th of a replay being node k. Each replay is checked
against the nodes: an operation's kind (kernel, memcpy, memset) and a
kernel's name (the profiler's, demangled as the profiler demangles the
driver's name) must be its node's. A replay that fails the check anywhere,
or a node whose name the driver could not give, leaves the replay
unplaced whole. A node's span path falls in one group:
`env.fresh` (the fresh-scene sampler), `env.transition` outside it,
`env.render`, `runner.actions` or `runner.stack` ("carry"); a node in no
span or in another is unplaced.

A program without the node map (one that records none) gives None.
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Optional

GRAPH = "runner.step"
# (group, span), the first span on a node's path naming its group.
GROUPS = (("fresh", "env.fresh"), ("transition", "env.transition"),
          ("render", "env.render"), ("carry", "runner.actions"),
          ("carry", "runner.stack"))
NAMES = ("fresh", "transition", "render", "carry", "unplaced")

_last = (None, None)  # (trace, its split): the readers share one


def runner_graph(with_nodes: bool = True):
    """The last capture record of the runner's step graph (with its node
    map where `with_nodes`), or None."""
    from spriteworld_torch.utils import profiling

    graphs = getattr(profiling, "graphs", None)
    if graphs is None:
        return None
    found = [g for g in graphs()
             if g.name == GRAPH and (g.nodes or not with_nodes)]
    return found[-1] if found else None


@functools.lru_cache(maxsize=None)
def _cxa_demangle():
    lib = ctypes.CDLL("libstdc++.so.6")
    fn = lib.__cxa_demangle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                   ctypes.POINTER(ctypes.c_size_t),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_void_p
    free = ctypes.CDLL(None).free
    free.argtypes = [ctypes.c_void_p]
    return fn, free


@functools.lru_cache(maxsize=None)
def demangle(name: str) -> str:
    """`name` as kineto names a kernel: abi::__cxa_demangle's reading of a
    mangled C++ name (`_Z...`), else `name` itself."""
    if not name.startswith("_Z"):
        return name
    fn, free = _cxa_demangle()
    status = ctypes.c_int(0)
    out = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value or not out:
        return name
    try:
        return ctypes.string_at(out).decode()
    finally:
        free(out)


def group_of(path: str) -> Optional[str]:
    names = path.split("/")
    for group, span in GROUPS:
        if span in names:
            return group
    return None


def split(ctx) -> Optional[dict]:
    """{group: device ms a step} of the slice's replayed runner-graph
    operations, with "unplaced" and "total", or None without a node map
    or replays. The first call for a trace prints the info line."""
    global _last
    if _last[0] is ctx.trace:
        return _last[1]
    out = _split(ctx)
    _last = (ctx.trace, out)
    return out


def _reading(kind: str, name: Optional[str]):
    """What the check compares of an operation: its kind and a kernel's
    name (None for a kernel node whose name the driver could not give,
    which no operation matches)."""
    return (kind, name if kind == "kernel" else "")


def _split(ctx) -> Optional[dict]:
    g = runner_graph()
    ops = sorted((o for o in ctx.trace.span_ops("rollout")
                  if o.via.startswith("cudaGraphLaunch")),
                 key=lambda o: o.start)
    if g is None or not ops or not ctx.steps:
        return None
    n = len(g.nodes)
    want = [_reading(kind, name and demangle(name))
            for kind, _, name in g.nodes]
    paths = [g.path(s) if s >= 0 else "" for _, s, _ in g.nodes]
    groups = [group_of(p) or "unplaced" for p in paths]
    ns = dict.fromkeys(NAMES, 0)
    by_path = {}
    placed_ops = unplaced_ops = unplaced_replays = 0
    first_mismatch = None
    for r in range(0, len(ops), n):
        chunk = ops[r:r + n]
        got = [_reading(o.kind, o.name) for o in chunk]
        if got != want:
            ns["unplaced"] += sum(o.end - o.start for o in chunk)
            unplaced_ops += len(chunk)
            unplaced_replays += 1
            if first_mismatch is None:
                k = next((k for k, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), n))
                first_mismatch = [r + k] + [
                    str(x[k])[:160] if k < len(x) else None
                    for x in (got, want)]
            continue
        for o, group, path in zip(chunk, groups, paths):
            ns[group] += o.end - o.start
            by_path[path] = by_path.get(path, 0) + o.end - o.start
            if group == "unplaced":
                unplaced_ops += 1
            else:
                placed_ops += 1
    per_step = {k: v / 1e6 / ctx.steps for k, v in ns.items()}
    per_step["total"] = sum(o.end - o.start for o in ops) / 1e6 / ctx.steps
    nodes = {}
    for path in paths:
        nodes[path] = nodes.get(path, 0) + 1
    print(json.dumps({"node_map": {
        "graph": g.name, "nodes": n, "other_nodes": g.other_nodes,
        "placed_nodes": sum(grp != "unplaced" for grp in groups),
        "unplaced_nodes": sum(grp == "unplaced" for grp in groups),
        "unnamed_kernels": sum(w == ("kernel", None) for w in want),
        "replays": -(-len(ops) // n), "unplaced_replays": unplaced_replays,
        "first_mismatch": first_mismatch,
        "replayed_ops": len(ops), "placed_ops": placed_ops,
        "unplaced_ops": unplaced_ops, "ms_a_step": per_step,
        "spans": {p: [by_path.get(p, 0) / 1e6 / ctx.steps, c]
                  for p, c in sorted(nodes.items())},
        "census": g.census_table()}}), flush=True)
    return per_step
