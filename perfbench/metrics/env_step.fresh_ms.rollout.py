"""env_step.fresh_ms.rollout: device ms a step of the runner graph's
replayed operations whose node the fresh-scene sampler launched at capture
(span `env.fresh`: the sampler's generators and rejection nodes, the
state's fill and the task's validity), over the profiled slice
(`perfbench/nodemap.py`). Moves env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    split = nodemap.split(ctx)
    return None if split is None else split["fresh"]
