"""COBRA exploration task: no reward, 1-6 random sprites, 10-step episodes.

Counterpart of `spriteworld_tpu/configs/cobra/exploration.py`.
"""

from __future__ import annotations

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks
from spriteworld_torch.configs.cobra import common


def get_config(mode=None):
    del mode  # No train/test split for pure exploration.

    factors = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Discrete("shape", ["square", "triangle", "circle"]),
        distribs.Discrete("scale", [0.13]),
        distribs.Continuous("c0", 0.0, 1.0),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])
    sprite_gen = generators.generate_sprites(
        factors, num_sprites=generators.RandInt(1, 7))

    return {
        "task": tasks.NoReward(),
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": 10,
        "metadata": {"name": "exploration.py"},
    }
