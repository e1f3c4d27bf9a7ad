"""Device time a step of the runner graph's replayed nodes under a span,
wherever on a node's path the span lies.

The same node map as `perfbench/nodemap.py` (its functions, its check of
each replay against the graph's nodes by kind and kernel name), read by
span path rather than by group: a node counts for every span on its
path, so that a span the step opens in several places (`env.task` under
the fresh scene, the transition and the render) is charged with all of
them. A replay that fails the check counts for no span.

A program without the node map, or whose map has no node under the span
(one that does not open it), gives None.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from perfbench import nodemap

_last = (None, None)  # (trace, its table): the readers share one


def by_path(ctx) -> Optional[Dict[str, int]]:
    """{span path: device ns} of the slice's replays that fit the node
    map ("" for nodes in no span), or None without a map or replays."""
    global _last
    if _last[0] is not ctx.trace:
        _last = (ctx.trace, _by_path(ctx))
    return _last[1]


def _by_path(ctx) -> Optional[Dict[str, int]]:
    g = nodemap.runner_graph()
    ops = sorted((o for o in ctx.trace.span_ops("rollout")
                  if o.via.startswith("cudaGraphLaunch")),
                 key=lambda o: o.start)
    if g is None or not ops or not ctx.steps:
        return None
    n = len(g.nodes)
    want = [nodemap._reading(kind, name and nodemap.demangle(name))
            for kind, _, name in g.nodes]
    paths = [g.path(s) if s >= 0 else "" for _, s, _ in g.nodes]
    out = dict.fromkeys(paths, 0)
    for r in range(0, len(ops), n):
        chunk = ops[r:r + n]
        if [nodemap._reading(o.kind, o.name) for o in chunk] != want:
            continue
        for o, path in zip(chunk, paths):
            out[path] += o.end - o.start
    return out


def ms_under(ctx, match: Callable[[str], bool]) -> Optional[float]:
    """Device ms a step of the nodes with a span on their path whose name
    `match`es, or None where no node has one."""
    table = by_path(ctx)
    if table is None:
        return None
    hits = [ns for path, ns in table.items()
            if any(match(name) for name in path.split("/"))]
    if not hits:
        return None
    return sum(hits) / 1e6 / ctx.steps
