"""env_step.task_ms.rollout: device ms a step of the runner graph's
replayed operations whose node a task launched at capture (span
`env.task`, with its subtasks' `env.task.<Class>#<i>`: the reward,
success and validity of the transition, the validity of the fresh scene
and the success the render shows), over the profiled slice
(`perfbench/spans.py`). Moves env_steps_per_s."""

from perfbench import spans


def read(ctx):
    return spans.ms_under(ctx, lambda name: name == "env.task"
                          or name.startswith("env.task."))
