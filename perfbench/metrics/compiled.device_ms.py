"""compiled.device_ms: device-busy ms a step() call: the union of the
device operations launched inside the adapter's step() calls (the compiled
step's graph replay, its copies and the fetch), over the calls in the
profiled slice. Moves step_ms."""


def read(ctx):
    t = ctx.trace
    ops = t.span_ops("step")
    if not ops or not ctx.steps:
        return None
    return t.busy_s(ops) * 1e3 / ctx.steps
