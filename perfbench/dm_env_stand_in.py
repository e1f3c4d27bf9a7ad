"""`import dm_env` for a machine that lacks the package.

A copy of `chip_smoke.dm_env_stand_in`: within the block, `import dm_env`
finds the installed package or, where it is not installed, a stand-in with
what the port's adapter and action spaces call: `Environment`, `StepType`,
`TimeStep`, `restart`/`transition`/`termination` and `specs.Array`,
`BoundedArray`, `DiscreteArray` (with `validate`).
"""

from __future__ import annotations

import collections
import contextlib
import enum
import importlib.util
import sys
import types

import numpy as np


@contextlib.contextmanager
def dm_env_stand_in():
    """Yields whether the real package is installed; where it is not, the
    stand-in is in `sys.modules` within the block."""
    if importlib.util.find_spec("dm_env") is not None:
        yield True
        return

    class StepType(enum.IntEnum):
        FIRST = 0
        MID = 1
        LAST = 2

    time_step = collections.namedtuple(
        "TimeStep", "step_type reward discount observation")

    class Array:
        def __init__(self, shape, dtype, name=None):
            self.shape, self.dtype, self.name = (tuple(shape),
                                                 np.dtype(dtype), name)

        def validate(self, value):
            value = np.asarray(value)
            if value.shape != self.shape or (
                    self.dtype != object and value.dtype != self.dtype):
                raise ValueError(f"{value.shape} {value.dtype} against "
                                 f"{self.shape} {self.dtype}")
            return value

    class BoundedArray(Array):
        def __init__(self, shape, dtype, minimum, maximum, name=None):
            super().__init__(shape, dtype, name)
            self.minimum, self.maximum = minimum, maximum

    class DiscreteArray(BoundedArray):
        def __init__(self, num_values, dtype=np.int32, name=None):
            super().__init__((), dtype, 0, num_values - 1, name)
            self.num_values = num_values

    specs = types.ModuleType("dm_env.specs")
    specs.Array, specs.BoundedArray = Array, BoundedArray
    specs.DiscreteArray = DiscreteArray
    mod = types.ModuleType("dm_env")
    mod.specs, mod.StepType, mod.TimeStep = specs, StepType, time_step
    mod.Environment = type("Environment", (), {})
    mod.restart = lambda observation: time_step(
        StepType.FIRST, None, None, observation)
    mod.transition = lambda reward, observation, discount=1.0: time_step(
        StepType.MID, reward, discount, observation)
    mod.termination = lambda reward, observation: time_step(
        StepType.LAST, reward, 0.0, observation)
    sys.modules["dm_env"], sys.modules["dm_env.specs"] = mod, specs
    try:
        yield False
    finally:
        for name in ("dm_env", "dm_env.specs",
                     "spriteworld_torch.adapters.dm_env_adapter"):
            sys.modules.pop(name, None)
