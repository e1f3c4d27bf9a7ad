"""A task tree's reward, success and validity in one kernel launch.

A task (`core/tasks.py`) maps factors f32[B, K, 10] and live counts [B]
to reward f32[B], success bool[B] and validity bool[B]. Evaluated
through the tasks' own methods that is a few dozen small PyTorch
operations a node: every `FindGoalPosition` masks, measures and folds its
sprites, every `Clustering` labels them and computes a Davies-Bouldin
index, and a `MetaAggregated` runs each subtask once for each output.

On CUDA factors `task_eval` computes all three in one launch of
`csrc/task_eval.cu`, from a flat table that describes the tree.
`core.tasks.task_table` builds it once from the task, and
`core.tasks.Evaluator` picks the route: this kernel where the tree has a
table and the factors are on the card, the tasks' methods (the kernel's
plain twin, which it equals bit for bit) everywhere else.

The table is int32 words (floats by their bits): a header, the task
nodes in postfix order (children before their parent), then the
predicate programs that the filters and cluster distributions compile to,
each a postfix program over one sprite's factors ending in P_END.

  header            task nodes, the most entries the task stack holds
  T_GOAL            pred, goal x, goal y, weight x, weight y, terminate
                    distance, reward multiplier, bonus, sparse
  T_CLUSTER         clusters C, threshold, bonus, reward range, sparse,
                    C preds
  T_NO_REWARD
  T_META            subtasks n, aggregator (A_SUM, A_MAX, A_MIN),
                    criterion (C_ALL, C_ANY), bonus given, bonus

  P_TRUE            (no filter)
  P_CONTINUOUS      column, lo, hi: lo <= v < hi
  P_DISCRETE        column, n, n candidates: v equals one
  P_ALL / P_ANY     n: all / any of the last n results (Product,
                    Intersection, Selection / Mixture)
  P_AND_NOT         the last but one and not the last (SetMinus)

Each launch adds one to `task_eval.launches` and `.by_site[site]`, the
caller's name for where in the step it evaluates, and to the census of a
graph being captured.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import _build
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling

# Task nodes, predicate operations, aggregators and criteria: the opcodes
# of csrc/task_eval.cu.
T_GOAL, T_CLUSTER, T_NO_REWARD, T_META = 1, 2, 3, 4
P_END, P_TRUE, P_CONTINUOUS, P_DISCRETE, P_ALL, P_ANY, P_AND_NOT = range(7)
A_SUM, A_MAX, A_MIN = 0, 1, 2
C_ALL, C_ANY = 0, 1
HEADER = 2
# The kernel's limits: sprite slots (a warp a lane, a thread a slot),
# clusters of a Clustering (a thread a pair of clusters), entries of the
# task stack, bits of the predicate stack (one 32-bit word), and the
# table's words (held in shared memory).
MAX_SLOTS = 32
MAX_CLUSTERS = 5
MAX_TASK_DEPTH = 8
MAX_PRED_DEPTH = 31
MAX_WORDS = 4096
# The outputs a caller asks for (the kernel's `want` bits).
REWARD, SUCCESS, VALID = 1, 2, 4


def f32_bits(x) -> int:
    """The int32 word of float32(x)."""
    return int(np.float32(x).view(np.int32))


def takes(factors: torch.Tensor) -> bool:
    """Whether the kernel takes `factors`: float32 [B, K, 10] on the card,
    K at most MAX_SLOTS."""
    return (factors.is_cuda and factors.dtype == torch.float32
            and factors.dim() == 3
            and factors.shape[-1] == state_lib.NUM_FACTORS
            and factors.shape[1] <= MAX_SLOTS)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, task_eval_launch typed)."""
    lib = _build.load("task_eval")
    fn = lib.task_eval_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return lib, fn


def task_eval(table: np.ndarray, factors: torch.Tensor,
              num_sprites: torch.Tensor, want: int, site: str):
    """One launch of `csrc/task_eval.cu` over CUDA factors f32[B, K, 10]
    (columns contiguous) and num_sprites [B]: (reward f32[B], success
    bool[B], valid bool[B]) of the task that `table` (its int32 words)
    describes, bit for bit
    what its methods give; an output not in `want` (REWARD | SUCCESS |
    VALID) is None. Runs on the current stream; raises where the kernel
    cannot take the input or cannot launch."""
    if not takes(factors):
        raise ValueError(f"task_eval takes CUDA factors f32[B, K <= "
                         f"{MAX_SLOTS}, {state_lib.NUM_FACTORS}], got "
                         f"{tuple(factors.shape)} {factors.dtype} on "
                         f"{factors.device}")
    b, k, _ = factors.shape
    if num_sprites.shape != (b,) or num_sprites.device != factors.device:
        raise ValueError(f"num_sprites must be [{b}] on {factors.device}, "
                         f"got {tuple(num_sprites.shape)} on "
                         f"{num_sprites.device}")
    if not want or want & ~(REWARD | SUCCESS | VALID):
        raise ValueError(f"want is a nonzero union of REWARD, SUCCESS and "
                         f"VALID, got {want}")
    dev = factors.device
    if factors.stride(-1) != 1:
        factors = factors.contiguous()
    num = num_sprites.to(torch.int32)
    reward = (torch.empty(b, dtype=torch.float32, device=dev)
              if want & REWARD else None)
    success = (torch.empty(b, dtype=torch.bool, device=dev)
               if want & SUCCESS else None)
    valid = (torch.empty(b, dtype=torch.bool, device=dev)
             if want & VALID else None)
    if b:
        words = device_lib.constant(table, dev)
        lib, launch = _launcher()
        current = torch.cuda.current_device()
        with (contextlib.nullcontext() if dev.index in (None, current)
              else torch.cuda.device(dev)):
            err = launch(factors.data_ptr(), factors.stride(0),
                         factors.stride(1), num.data_ptr(), num.stride(0),
                         words.data_ptr(), len(table), b, k,
                         _ptr(reward), _ptr(success), _ptr(valid),
                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"task_eval kernel failed to launch: CUDA error {err} "
                f"({_build.error_string(lib, err)})")
    task_eval.launches += 1
    task_eval.by_site[site] = task_eval.by_site.get(site, 0) + 1
    profiling.count("task_eval", site, slots=k)
    return reward, success, valid


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def reset_launch_counts():
    """Set `task_eval`'s launch counts to 0."""
    task_eval.launches = 0
    task_eval.by_site = {}


reset_launch_counts()
