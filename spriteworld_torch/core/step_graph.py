"""One step that reads and writes carried tensors in place, replayed from a
CUDA graph or launched eagerly.

The port's counterpart of `jax.jit` for a stateful step: the runner
(`parallel/runner.py`), the trainer (`train_example_torch.py`) and the
compiled reset, step and observation of `core/environment.py` (which the
dm_env adapter and `utils/media.py` replay) are each a `StepGraph`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from spriteworld_torch.core import distributions
from spriteworld_torch.utils import profiling


def use_graph_for(device: torch.device, use_graph: Optional[bool]) -> bool:
    """Whether a step on `device` replays a graph: by default on a CUDA
    device and not on the CPU; True on the CPU raises. Nothing falls back
    to the eager step on the card: the caller asks for it."""
    is_cuda = torch.device(device).type == "cuda"
    use_graph = is_cuda if use_graph is None else bool(use_graph)
    if use_graph and not is_cuda:
        raise ValueError(
            f"use_graph=True needs a CUDA environment; this one runs on "
            f"{device}")
    return use_graph


class StepGraph:
    """One step that reads and writes carried tensors in place, run a
    number of times: replayed from a CUDA graph or launched eagerly.

    With `use_graph`, `step()` is captured after one eager warm-up step
    (which builds the kernels and fills the device-constant caches), inside
    `distributions.defer_rejection(pending)`. The step's randomness is
    carried state (the lanes' keys, split in place like any other carried
    tensor), so a replay draws what the eager step would from the same
    carried tensors, and nothing but those tensors needs saving. The warm-up
    writes the carried tensors: a caller that needs them unchanged saves
    and restores them around the construction. `rejects` says
    whether the captured step holds a rejection node: where it does not,
    a replay can never set `pending`, which then need not be read. The
    runner, the trainer (`train_example_torch.py`) and the environment's
    compiled programs (`core.environment.Compiled`) share this: run the
    steps deferred, read `pending` at the boundary, and where it is set run
    them again with `run(n, step, defer=False)` from the same start
    (host-checked rejection continues each element's rounds).

    The step is passed again to `run` rather than kept: a step that
    refers to its owner would make a reference cycle through the owner's
    programs, and the garbage collector could then free a graph during
    another capture, which CUDA refuses.

    The capture is recorded under `name` (`utils.profiling.capture`):
    `record` holds the graph's node map and kernel census.
    """

    def __init__(self, step: Callable[[], None], pending: torch.Tensor,
                 use_graph: bool, name: str = "step"):
        self.pending = pending
        self.graph = None
        self.record = None
        self.rejects = False
        if use_graph:
            with distributions.defer_rejection(pending) as deferral:
                step()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                with profiling.capture(name) as record, \
                        distributions.defer_rejection(pending):
                    step()
            self.graph, self.record = graph, record
            self.rejects = deferral.nodes > 0

    def run(self, n: int, step: Callable[[], None], defer: bool = True):
        """`n` steps: replays of the graph, or `step()` launched eagerly
        (without a graph, or with `defer=False`). With `defer`, rejection
        that runs past its first rounds sets `pending` (no host sync),
        else it asks the host."""
        for _ in range(n):
            if self.graph is not None and defer:
                self.graph.replay()
                continue
            ctx = (distributions.defer_rejection(self.pending) if defer
                   else contextlib.nullcontext())
            with ctx:
                step()
