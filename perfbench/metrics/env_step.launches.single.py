"""env_step.launches.single: kernels a step() call launched (a graph
replay's kernels counted one by one), over the profiled slice. Moves
step_ms."""


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("step") if o.kind == "kernel"]
    if not ks or not ctx.steps:
        return None
    return len(ks) / ctx.steps
