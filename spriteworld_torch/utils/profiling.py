"""Tracing, profiling and numeric-debug helpers.

Counterpart of `spriteworld_tpu/utils/profiling.py`, on torch:

  * `trace(path)` — a `torch.profiler` trace of the enclosed region (host
    operators, and the card's kernels where there is one), written as a
    Chrome trace under `path`.
  * `annotate(name)` — a named range in that trace
    (`torch.profiler.record_function`), and an NVTX range once CUDA is in
    use, so that the environment's transition and render show up labelled.
  * `enable_debug_checks()` — raises FloatingPointError where an operation
    returns a NaN or an Inf, while enabled (a `TorchDispatchMode`).
  * `sync(value)` — waits for the card's work behind a tensor; a no-op for
    CPU tensors.
  * `StepTimer` — env-steps/s across rollout chunks, synchronising before
    it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in profiler traces (and NVTX on CUDA)."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(path: str):
    """Profile the enclosed region; writes `path`/trace.json (Chrome
    format). Yields the `torch.profiler.profile` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def _leaves(value):
    if isinstance(value, dict):
        return [x for v in value.values() for x in _leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    return [value] if isinstance(value, torch.Tensor) else []


class _DebugChecks(TorchDispatchMode):
    """Raises FloatingPointError on a NaN (and/or Inf) floating output."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if not t.is_floating_point():
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


# The mode `enable_debug_checks` entered, as JAX's jax_debug_nans/infs flags
# are one setting of the process.
_ACTIVE = []


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    """Check every operation's floating outputs for NaN/Inf from now on;
    `enable_debug_checks(False, False)` turns the checks off. Each check
    reads the result on the host, so it syncs with the card."""
    while _ACTIVE:
        _ACTIVE.pop().__exit__(None, None, None)
    if nans or infs:
        mode = _DebugChecks(bool(nans), bool(infs))
        mode.__enter__()
        _ACTIVE.append(mode)


def sync(value) -> None:
    """Wait for the card's work behind the first tensor in `value` (a
    tensor, or a dict/list/tuple of them); nothing for CPU tensors."""
    leaves = _leaves(value)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class StepTimer:
    """Wall-clock env-steps/s measurement across rollout chunks."""

    def __init__(self):
        self._steps = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, num_steps: int, sync_on=None) -> None:
        if sync_on is not None:
            sync(sync_on)
        self._elapsed += time.perf_counter() - self._t0
        self._steps += int(num_steps)
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self._steps / self._elapsed if self._elapsed else 0.0
