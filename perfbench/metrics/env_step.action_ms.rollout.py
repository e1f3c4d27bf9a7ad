"""env_step.action_ms.rollout: device ms a step of the runner graph's
replayed operations whose node the action space's step launched at
capture (span `env.action`, inside `env.transition`: SelectMove's or
DragAndDrop's pick and move, Embodied's body, carry and move), over the
profiled slice (`perfbench/spans.py`). None where the program opens no
such span. Moves env_steps_per_s."""

from perfbench import spans


def read(ctx):
    return spans.ms_under(ctx, lambda name: name == "env.action")
