"""env_step.clustering_ms.rollout: device ms a step of the runner graph's
replayed operations whose node a Clustering subtask launched at capture
(spans `env.task.Clustering#<i>`: its membership and Davies-Bouldin
index in the reward, the successes and the validity checks), over the
profiled slice (`perfbench/spans.py`). None where the program opens no
such span. Moves env_steps_per_s."""

from perfbench import spans


def read(ctx):
    return spans.ms_under(
        ctx, lambda name: name.startswith("env.task.Clustering#"))
