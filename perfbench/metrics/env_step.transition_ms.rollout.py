"""env_step.transition_ms.rollout: device ms a step of the runner graph's
replayed operations whose node the transition launched at capture outside
the fresh-scene sampler (span `env.transition` less `env.fresh`: the key
split, the action space, integration, the task's reward, success and
validity, and the select of fresh lanes), over the profiled slice
(`perfbench/nodemap.py`). Moves env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    split = nodemap.split(ctx)
    return None if split is None else split["transition"]
