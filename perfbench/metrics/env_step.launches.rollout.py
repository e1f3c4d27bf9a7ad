"""env_step.launches.rollout: kernels a step launched in rollout calls (a
graph replay's kernels counted one by one), over the profiled slice.
Moves env_steps_per_s."""


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("rollout") if o.kind == "kernel"]
    if not ks or not ctx.steps:
        return None
    return len(ks) / ctx.steps
