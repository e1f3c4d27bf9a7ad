"""Embodied goal-finding example: carry targets to the arena center.

Counterpart of `spriteworld_tpu/configs/examples/goal_finding_embodied.py`:
1-3 targets + 1-3 distractors (random counts), plus a magenta circular
agent body appended last (foreground), with the Embodied adhere-and-carry
action space.
"""

from __future__ import annotations

from spriteworld_torch.core import actions
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import renderers as renderers_lib
from spriteworld_torch.core import tasks

TERMINATE_DISTANCE = 0.075


def get_config(mode=None):
    del mode

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

    scene_gen = generators.shuffle(generators.chain_generators(
        generators.generate_sprites(
            distribs.Product([target_hue, shared_factors]),
            generators.RandInt(1, 4)),
        generators.generate_sprites(
            distribs.Product([distractor_hue, shared_factors]),
            generators.RandInt(1, 4)),
    ))

    # Agent body appended after the shuffle so it is always the foreground
    # sprite: the Embodied action space treats the last live sprite as the
    # body.
    agent_body = generators.generate_sprites(
        distribs.Product([
            distribs.Continuous("x", 0.1, 0.9),
            distribs.Continuous("y", 0.1, 0.9),
            distribs.Discrete("shape", ["circle"]),
            distribs.Discrete("scale", [0.07]),
            distribs.Discrete("c0", [1.0]),
            distribs.Discrete("c1", [0.0]),
            distribs.Discrete("c2", [1.0]),
        ]), num_sprites=1)
    sprite_gen = generators.chain_generators(scene_gen, agent_body)

    renderers = {
        "image": renderers_lib.ImageRenderer(
            image_size=(64, 64), anti_aliasing=5, color_to_rgb="hsv")
    }

    return {
        "task": tasks.FindGoalPosition(
            filter_distrib=target_hue,
            terminate_distance=TERMINATE_DISTANCE),
        "action_space": actions.Embodied(step_size=0.05),
        "renderers": renderers,
        "init_sprites": sprite_gen,
        "max_episode_length": 50,
        "metadata": {"name": "goal_finding_embodied.py"},
    }
