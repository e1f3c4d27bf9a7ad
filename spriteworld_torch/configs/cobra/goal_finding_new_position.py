"""COBRA goal-finding with generalization to new initial positions.

Counterpart of `spriteworld_tpu/configs/cobra/goal_finding_new_position.py`:
one orange-green target + one blue-purple distractor; train positions
exclude the quadrant x, y in [0.5, 0.9) (SetMinus), test positions lie only
in it.
"""

from __future__ import annotations

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks
from spriteworld_torch.configs.cobra import common

TERMINATE_DISTANCE = 0.075
NUM_TARGETS = 1
NUM_DISTRACTORS = 1


def _mode_target_positions(mode):
    full = distribs.Product((
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
    ))
    quadrant = distribs.Product((
        distribs.Continuous("x", 0.5, 0.9),
        distribs.Continuous("y", 0.5, 0.9),
    ))
    return {
        "train": distribs.SetMinus(full, quadrant),
        "test": quadrant,
    }[mode]


def get_config(mode="train"):
    shared_factors = distribs.Product([
        distribs.Discrete("shape", ["square", "triangle", "circle"]),
        distribs.Discrete("scale", [0.13]),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])
    target_hue = distribs.Continuous("c0", 0.0, 0.4)
    distractor_hue = distribs.Continuous("c0", 0.5, 0.9)
    target_factors = distribs.Product([
        _mode_target_positions(mode),
        target_hue,
        shared_factors,
    ])
    distractor_factors = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distractor_hue,
        shared_factors,
    ])

    sprite_gen = generators.shuffle(generators.chain_generators(
        generators.generate_sprites(target_factors, NUM_TARGETS),
        generators.generate_sprites(distractor_factors, NUM_DISTRACTORS),
    ))

    task = tasks.FindGoalPosition(
        filter_distrib=target_hue, terminate_distance=TERMINATE_DISTANCE)

    return {
        "task": task,
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": 20,
        "metadata": {"name": "goal_finding_new_position.py", "mode": mode},
    }
