"""runner.carry_ms.rollout: device ms a step of the runner graph's
replayed operations whose node the runner itself launched at capture
(spans `runner.actions`, the action key's split and the policy's draws,
and `runner.stack`, the metric accumulators, the state's copy back and the
stacking of the TimeStep), over the profiled slice
(`perfbench/nodemap.py`). With the three `env_step.*_ms.rollout` node
metrics and the unplaced operations it adds up to the replays' device
time a step. Moves env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    split = nodemap.split(ctx)
    return None if split is None else split["carry"]
