"""Action spaces as batched state-update functions.

Counterpart of `spriteworld_tpu/core/actions.py`:

  * SelectMove / DragAndDrop: motion = (click2 - 0.5) * scale (SelectMove)
    or (click2 - click1) * scale (DragAndDrop); optional Gaussian action
    noise; the topmost (foreground-most) live sprite containing click1
    moves, clipped to the frame when `keep_in_frame`; cost = -motion_cost *
    ||motion||.
  * Embodied: the last live sprite is the agent's body; an action is the
    integer pair [carry in {0, 1}, direction in {0..3}] (up, left, down,
    right). When carrying, the topmost non-body sprite containing the body's
    centre (decided from positions before the move) moves first, then the
    body; cost = -motion_cost * step_size.

Random actions and action noise draw from per-lane keys int32[B, 2]
(`ops.lane_random`), one a lane, as the JAX action spaces draw from theirs.
Each `step` counts its calls into the census of a graph being captured
(`utils.profiling.evaluation`, as `action.<Class>`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spriteworld_torch.ops import geometry, lane_random
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling


def _move_sprite(factors, idx, motion, do_move, keep_in_frame: bool):
    """Move sprite idx[b] of each lane b by motion[b] where do_move[b]."""
    k = factors.shape[-2]
    sel = (torch.arange(k, device=factors.device) == idx[:, None]) \
        & do_move[:, None]  # [B, K]
    pos = factors[..., 0:2]
    new_pos = pos + motion[:, None, :]
    if keep_in_frame:
        new_pos = new_pos.clamp(0.0, 1.0)
    out = factors.clone()
    out[..., 0:2] = torch.where(sel[..., None], new_pos, pos)
    return out


class SelectMove:
    """Two-click select-and-move: [click_x, click_y, motion_x, motion_y]."""

    ACTION_SIZE = 4

    def __init__(self, scale: float = 1.0, motion_cost: float = 0.0,
                 noise_scale: Optional[float] = None):
        self._scale = scale
        self._motion_cost = motion_cost
        self._noise_scale = noise_scale

    def get_motion(self, action):
        return (action[..., 2:] - 0.5) * self._scale

    def apply_noise_to_action(self, action, key):
        """`action` f32[B, 4] plus Gaussian noise of each lane's key (key
        int32[B, 2])."""
        if not self._noise_scale:
            return action
        noise = lane_random.normal(key, action.shape[-1], action.dtype)
        return action + self._noise_scale * noise

    @profiling.evaluation(kind="action")
    def step(self, action, factors, num_sprites, keep_in_frame: bool,
             key: torch.Tensor):
        """action f32[B, 4], factors f32[B, K, 10], num_sprites i32[B],
        lane keys int32[B, 2] (the noise's) -> (factors', cost f32[B])."""
        action = self.apply_noise_to_action(action, key)
        position = action[..., :2]
        motion = self.get_motion(action)
        hits = geometry.sprites_containing_point(factors, position)
        idx, any_hit = geometry.topmost_hit(hits, num_sprites)
        factors = _move_sprite(factors, idx, motion, any_hit, keep_in_frame)
        cost = -self._motion_cost * torch.linalg.vector_norm(motion, dim=-1)
        return factors, cost

    def sample(self, key: torch.Tensor):
        """Uniform random actions f32[B, 4], one a lane key of `key`
        int32[B, 2]."""
        return lane_random.uniform(key, 4)

    def action_spec(self):
        """The dm_env spec of one lane's action (imported here, so that
        nothing on the step path needs dm_env)."""
        from dm_env import specs

        return specs.BoundedArray(
            shape=(4,), dtype=np.float32, minimum=0.0, maximum=1.0)

    @property
    def action_shape_dtype(self):
        """(shape, dtype) of one lane's action; every action is cast to the
        dtype on its way into a step."""
        return (4,), torch.float32


class DragAndDrop(SelectMove):
    """Like SelectMove, but the motion is relative to the first click."""

    def get_motion(self, action):
        return (action[..., 2:] - action[..., :2]) * self._scale


class Embodied:
    """Grid-motion embodied agent with adhere-and-carry physics."""

    ACTION_SIZE = 2

    def __init__(self, step_size: float = 0.05, motion_cost: float = 0.0):
        self._step_size = step_size
        self._motion_cost = motion_cost
        # Motion table rows: up, left, down, right.
        self._motions = np.array(
            [[0.0, step_size], [-step_size, 0.0],
             [0.0, -step_size], [step_size, 0.0]], dtype=np.float32)

    @profiling.evaluation(kind="action")
    def step(self, action, factors, num_sprites, keep_in_frame: bool,
             key: torch.Tensor):
        """action i32[B, 2], factors f32[B, K, 10], num_sprites i32[B] ->
        (factors', cost f32[B]); `key` is unused (no noise)."""
        del key
        b = factors.shape[0]
        motion = device_lib.constant(self._motions, factors.device)[
            action[:, 1].long()]
        body_idx = (num_sprites - 1).clamp(min=0).long()
        body_pos = factors[torch.arange(b, device=factors.device),
                           body_idx, 0:2]
        hits = geometry.sprites_containing_point(factors, body_pos)
        carried_idx, has_carried = geometry.topmost_hit(hits, body_idx)
        do_carry = has_carried & (action[:, 0] > 0)
        factors = _move_sprite(factors, carried_idx, motion, do_carry,
                               keep_in_frame)
        factors = _move_sprite(factors, body_idx, motion, num_sprites > 0,
                               keep_in_frame)
        cost = torch.full((b,), -self._motion_cost * self._step_size,
                          dtype=torch.float32, device=factors.device)
        return factors, cost

    def sample(self, key: torch.Tensor):
        """Uniform random actions i32[B, 2], one a lane key of `key`
        int32[B, 2] (split in two, as the JAX space splits it)."""
        keys = lane_random.split(key, 2)
        return torch.cat([lane_random.randint(keys[..., 0, :], 1, 0, 2),
                          lane_random.randint(keys[..., 1, :], 1, 0, 4)], -1)

    def action_spec(self):
        """The dm_env spec of one lane's action: [carry, direction] as two
        int64 DiscreteArrays, as the reference's."""
        from dm_env import specs

        return [
            specs.DiscreteArray(num_values=2, dtype=np.int64),
            specs.DiscreteArray(num_values=4, dtype=np.int64),
        ]

    @property
    def action_shape_dtype(self):
        """(shape, dtype) of one lane's action; every action is cast to the
        dtype on its way into a step."""
        return (2,), torch.int32
