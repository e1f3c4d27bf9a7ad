"""env_step.render_ms.rollout: device ms a step of the runner graph's
replayed operations whose node the render launched at capture (span
`env.render`: the task's success, the renderers' tables and
`scene_raster`), over the profiled slice (`perfbench/nodemap.py`). Moves
env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    split = nodemap.split(ctx)
    return None if split is None else split["render"]
