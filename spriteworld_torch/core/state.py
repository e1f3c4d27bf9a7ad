"""State of a batch of sprite environments, as dataclasses of tensors.

Counterpart of `spriteworld_tpu/core/state.py`. One struct of arrays with a
leading batch axis: a dense factor tensor `f32[B, MAX_SPRITES, 10]` plus a
live count per lane. Sprites are always *packed* — live sprites occupy the
slot prefix [0, num_sprites), and slot order is z-order (higher slot =
foreground). Each lane carries its own random key (`key`, the raw words
of a threefry key, `ops.lane_random`), as the JAX state does, so a step is
a function of the state and the action.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from spriteworld_torch.utils import device as device_lib

# Factor column layout — order matches the reference sprite.FACTOR_NAMES;
# the `shape` column holds the float-valued ShapeType id.
FACTOR_NAMES = (
    "x", "y", "shape", "angle", "scale", "c0", "c1", "c2", "x_vel", "y_vel")
FACTOR_INDEX: Dict[str, int] = {n: i for i, n in enumerate(FACTOR_NAMES)}
NUM_FACTORS = len(FACTOR_NAMES)

X, Y, SHAPE, ANGLE, SCALE, C0, C1, C2, X_VEL, Y_VEL = range(NUM_FACTORS)

# Defaults of the reference Sprite constructor: x=0.5, y=0.5,
# shape='square' (id 2), angle=0, scale=0.1, colors 0, velocities 0.
DEFAULT_FACTORS = np.array(
    [0.5, 0.5, 2.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=np.float32)


def default_factors(shape, device) -> torch.Tensor:
    """f32[*shape, 10] of default sprite factors."""
    row = device_lib.constant(DEFAULT_FACTORS, device)
    return row.expand(*shape, NUM_FACTORS).clone()


def default_factor_rows(num_rows: int, device="cuda") -> torch.Tensor:
    """f32[num_rows, 10] of default sprite factors on `device`."""
    return default_factors((num_rows,), device_lib.resolve(device))


def factors_to_dict(factors: torch.Tensor) -> Dict[str, torch.Tensor]:
    """View a factor tensor [..., 10] as a dict of per-factor tensors [...]."""
    return {name: factors[..., i] for i, name in enumerate(FACTOR_NAMES)}


class StepType:
    """Integer step types, numerically identical to dm_env.StepType."""

    FIRST = 0
    MID = 1
    LAST = 2


@dataclasses.dataclass
class TimeStep:
    """Batched timestep. FIRST steps carry reward 0 and discount 1; LAST
    steps carry discount 0."""

    step_type: torch.Tensor  # i32[B]
    reward: torch.Tensor  # f32[B]
    discount: torch.Tensor  # f32[B]
    observation: Any  # dict of tensors with a leading B axis

    def first(self):
        return self.step_type == StepType.FIRST

    def mid(self):
        return self.step_type == StepType.MID

    def last(self):
        return self.step_type == StepType.LAST


@dataclasses.dataclass
class EnvState:
    """Complete dynamic state of B environment lanes."""

    factors: torch.Tensor  # f32[B, MAX_SPRITES, 10]
    num_sprites: torch.Tensor  # i32[B]
    step_count: torch.Tensor  # i32[B]
    reset_next: torch.Tensor  # bool[B]
    # The lane's key: the words of a threefry key (jax.random.key_data).
    key: torch.Tensor  # int32[B, 2]
    # False where the scene's rejection sampling exhausted its bound.
    sample_ok: torch.Tensor  # bool[B]
    # False where the task's reward/success are undefined on this state.
    task_valid: torch.Tensor  # bool[B]

    def clone(self) -> "EnvState":
        """A copy of every field."""
        return EnvState(**{n: t.clone() for n, t in vars(self).items()})

    @property
    def alive(self) -> torch.Tensor:
        """bool[B, MAX_SPRITES] mask of live sprite slots."""
        k = self.factors.shape[-2]
        idx = torch.arange(k, device=self.factors.device)
        return idx < self.num_sprites[..., None]


_FIELD_DTYPES = {
    "factors": torch.float32,
    "num_sprites": torch.int32,
    "step_count": torch.int32,
    "reset_next": torch.bool,
    "key": torch.int32,
    "sample_ok": torch.bool,
    "task_valid": torch.bool,
}
STATE_FIELDS = tuple(_FIELD_DTYPES)


def state_from_numpy(d, device="cuda") -> EnvState:
    """An EnvState on `device` from the fields of the JAX package's EnvState.

    `d` maps each field name of `STATE_FIELDS` to an array (a dict, or any
    object with those attributes, e.g. a JAX EnvState). The key is taken
    as its words (`jax.random.key_data` of a typed JAX key, which is read
    through its underlying word array; raw uint32[..., 2] key data as it
    is), held as int32. Arrays keep their batch axis.
    """
    dev = device_lib.resolve(device)
    get = d.__getitem__ if isinstance(d, Mapping) else d.__getattribute__

    def field(name, dtype):
        value = get(name)
        if name == "key":
            # A typed JAX key converts to numpy only through its words.
            words = np.asarray(getattr(value, "_base_array", value))
            return torch.from_numpy(np.ascontiguousarray(
                words.astype(np.uint32)).view(np.int32)).to(dev)
        return torch.as_tensor(np.array(value), dtype=dtype, device=dev)

    return EnvState(**{name: field(name, dtype)
                       for name, dtype in _FIELD_DTYPES.items()})


def state_to_numpy(s: EnvState) -> Dict[str, np.ndarray]:
    """The fields of `s` as host numpy arrays, keyed by field name."""
    return {name: getattr(s, name).cpu().numpy() for name in STATE_FIELDS}
