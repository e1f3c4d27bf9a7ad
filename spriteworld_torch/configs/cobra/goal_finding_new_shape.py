"""COBRA goal-finding with generalization to new shapes.

Counterpart of `spriteworld_tpu/configs/cobra/goal_finding_new_shape.py`:
one sprite must reach the arena center; train shape is a square, test
shapes are triangle/circle.
"""

from __future__ import annotations

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks
from spriteworld_torch.configs.cobra import common

TERMINATE_DISTANCE = 0.075
NUM_TARGETS = 1

MODES_SHAPES = {
    "train": ["square"],
    "test": ["triangle", "circle"],
}


def get_config(mode="train"):
    factors = distribs.Product([
        distribs.Discrete("shape", MODES_SHAPES[mode]),
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Discrete("scale", [0.13]),
        distribs.Continuous("c0", 0.0, 0.4),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])
    sprite_gen = generators.shuffle(
        generators.generate_sprites(factors, NUM_TARGETS))

    return {
        "task": tasks.FindGoalPosition(
            terminate_distance=TERMINATE_DISTANCE),
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": 20,
        "metadata": {"name": "goal_finding_new_shape.py", "mode": mode},
    }
