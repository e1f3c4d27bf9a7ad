"""env_step.torch_ms.rollout: device ms a step of the kernels launched in
rollout calls that are not the port's own CUDA kernels (`scene_raster`,
`strip_*`, `packed_raster`, `lane_random`, by symbol name): the PyTorch
kernels of sampling, transition, task, tables and the runner's metrics.
Moves env_steps_per_s."""

from perfbench.harness import PORT_KERNELS


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("rollout") if o.kind == "kernel"
          and not any(p in o.name for p in PORT_KERNELS)]
    if not ks or not ctx.steps:
        return None
    return sum(o.end - o.start for o in ks) / 1e6 / ctx.steps
