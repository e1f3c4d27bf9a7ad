"""runner.chunk_gap_ms: the device's idle ms at a boundary between two
rollout calls: within the stretch from the end of the last kernel that one
call's graph replays ran to the start of the first of the next call's, the
time in which no device operation ran (the runner's boundary read of its
metrics, the Python around it, the clone of the stacked timesteps and the
next call's loads, and the benchmark's own bookkeeping). The mean over the
profiled slice's boundaries; moves env_steps_per_s."""


def read(ctx):
    t = ctx.trace
    first, last = {}, {}
    for o in t.span_ops("rollout"):
        if o.via.startswith("cudaGraphLaunch"):
            first[o.span] = min(first.get(o.span, o.start), o.start)
            last[o.span] = max(last.get(o.span, o.end), o.end)
    calls = sorted(first)
    gaps = [t.idle_ns(last[a], first[b]) / 1e6
            for a, b in zip(calls, calls[1:])]
    return sum(gaps) / len(gaps) if gaps else None
