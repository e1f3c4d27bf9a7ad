"""COBRA goal-finding with generalization to more distractors.

Counterpart of
`spriteworld_tpu/configs/cobra/goal_finding_more_distractors.py`: always 2
targets; 1 distractor in train / 2 in test.
"""

from __future__ import annotations

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks
from spriteworld_torch.configs.cobra import common

TERMINATE_DISTANCE = 0.075
NUM_TARGETS = 2
MODES_NUM_DISTRACTORS = {"train": 1, "test": 2}


def get_config(mode="train"):
    shared_factors = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Discrete("shape", ["square", "triangle", "circle"]),
        distribs.Discrete("scale", [0.13]),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])
    target_hue = distribs.Continuous("c0", 0.0, 0.4)
    distractor_hue = distribs.Continuous("c0", 0.5, 0.9)

    sprite_gen = generators.shuffle(generators.chain_generators(
        generators.generate_sprites(
            distribs.Product([target_hue, shared_factors]), NUM_TARGETS),
        generators.generate_sprites(
            distribs.Product([distractor_hue, shared_factors]),
            MODES_NUM_DISTRACTORS[mode]),
    ))

    return {
        "task": tasks.FindGoalPosition(
            filter_distrib=target_hue,
            terminate_distance=TERMINATE_DISTANCE),
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": 20,
        "metadata": {
            "name": "goal_finding_more_distractors.py", "mode": mode},
    }
