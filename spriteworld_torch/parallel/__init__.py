"""Runner layer: lockstep rollout chunks replayed as CUDA graphs, metrics
on the device, and checkpoints.

Counterpart of `spriteworld_tpu/parallel/` on one device; its mesh module
(lanes sharded over several devices) is not ported yet.
"""

from spriteworld_torch.parallel.checkpoint import (  # noqa: F401
    restore_state, save_state)
from spriteworld_torch.parallel.runner import (  # noqa: F401
    EvalStats, Metrics, ShardedRunner)
