"""COBRA sorting task: bring color-coded sprites to their goal corners.

Counterpart of `spriteworld_tpu/configs/cobra/sorting.py`: 5 (hue-range ->
goal-position) subtasks; each episode uses a 2-subtask combination. Train
samples from all combinations except the held-out first one; test uses
exactly the held-out combination. MetaAggregated(sum, all).
"""

from __future__ import annotations

import itertools

import numpy as np

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks
from spriteworld_torch.configs.cobra import common

MAX_EPISODE_LENGTH = 50
TERMINATE_DISTANCE = 0.075
RAW_REWARD_MULTIPLIER = 20.0
NUM_TARGETS = 2

SUBTASKS = (
    {"hue": (0.9, 1.0), "goal_position": (0.75, 0.75)},    # red
    {"hue": (0.55, 0.65), "goal_position": (0.75, 0.25)},  # blue
    {"hue": (0.27, 0.37), "goal_position": (0.25, 0.75)},  # green
    {"hue": (0.73, 0.83), "goal_position": (0.25, 0.25)},  # purple
    {"hue": (0.1, 0.2), "goal_position": (0.5, 0.5)},      # yellow
)


def get_config(mode="train"):
    subtasks = []
    sprite_gen_per_subtask = []
    for subtask in SUBTASKS:
        hue = distribs.Continuous("c0", *subtask["hue"])
        subtasks.append(tasks.FindGoalPosition(
            filter_distrib=hue,
            goal_position=subtask["goal_position"],
            terminate_distance=TERMINATE_DISTANCE,
            raw_reward_multiplier=RAW_REWARD_MULTIPLIER))
        factors = distribs.Product((
            hue,
            distribs.Continuous("x", 0.1, 0.9),
            distribs.Continuous("y", 0.1, 0.9),
            distribs.Discrete("shape", ["square", "triangle", "circle"]),
            distribs.Discrete("scale", [0.13]),
            distribs.Continuous("c1", 0.3, 1.0),
            distribs.Continuous("c2", 0.9, 1.0),
        ))
        sprite_gen_per_subtask.append(
            generators.generate_sprites(factors, num_sprites=1))

    subtask_combos = list(
        itertools.combinations(np.arange(len(SUBTASKS)), NUM_TARGETS))
    if mode == "train":
        # Hold the first combination out.
        sprite_gen = generators.sample_generator([
            generators.chain_generators(
                *[sprite_gen_per_subtask[i] for i in combo])
            for combo in subtask_combos[1:]
        ])
    elif mode == "test":
        sprite_gen = generators.chain_generators(
            *[sprite_gen_per_subtask[i] for i in subtask_combos[0]])
    else:
        raise ValueError(f"Invalid mode {mode}.")

    sprite_gen = generators.shuffle(sprite_gen)

    task = tasks.MetaAggregated(
        subtasks, reward_aggregator="sum", termination_criterion="all")

    return {
        "task": task,
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": MAX_EPISODE_LENGTH,
        "metadata": {"name": "sorting.py", "mode": mode},
    }
