"""Runner layer: lockstep rollout chunks replayed as CUDA graphs, metrics
on the device, lanes sharded over the ranks of a process mesh, and
checkpoints.

Counterpart of `spriteworld_tpu/parallel/`: the 1-D 'envs' mesh is a
`torch.distributed` process group (one rank a card, NCCL; gloo on the CPU),
each rank steps its slice of the lanes, and metric sums are all-reduced.
"""

from spriteworld_torch.parallel.mesh import (  # noqa: F401
    env_mesh, env_sharding, initialize_multihost, replicated_sharding)
from spriteworld_torch.parallel.runner import (  # noqa: F401
    EvalStats, Metrics, ShardedRunner, StepGraph, rank_seed)
from spriteworld_torch.parallel.checkpoint import (  # noqa: F401
    restore_state, save_state)
