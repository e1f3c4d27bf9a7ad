"""Combined goal-finding + clustering kitchen-sink example (RGB colors).

Counterpart of `spriteworld_tpu/configs/examples/goal_finding_clustering.py`:
cluster triangles/squares/pentagons by color; bring reddish 4-spokes/stars
to the right side and greenish ones to the left (x-only distance weights);
circle distractors; train/test split on clustering colors and goal-finding
scales (SetMinus). Colors are RGB ints — the image renderer uses no HSV map.
"""

from __future__ import annotations

from spriteworld_torch.core import actions
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import renderers as renderers_lib
from spriteworld_torch.core import tasks


def get_config(mode="train"):
    common_factors = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Continuous("angle", 0, 360, dtype="int32"),
    ])
    goal_finding_scale_test = distribs.Continuous("scale", 0.08, 0.12)
    green_blue_colors = distribs.Product([
        distribs.Continuous("c1", 64, 256, dtype="int32"),
        distribs.Continuous("c2", 64, 256, dtype="int32"),
    ])
    if mode == "train":
        goal_finding_scale = distribs.SetMinus(
            distribs.Continuous("scale", 0.05, 0.15),
            goal_finding_scale_test)
        cluster_colors = distribs.Product([
            distribs.Continuous("c0", 128, 256, dtype="int32"),
            green_blue_colors])
    elif mode == "test":
        goal_finding_scale = goal_finding_scale_test
        cluster_colors = distribs.Product([
            distribs.Continuous("c0", 0, 128, dtype="int32"),
            green_blue_colors])
    else:
        raise ValueError(
            f'Invalid mode {mode}. Mode must be "train" or "test".')

    sprite_gen_list = []
    cluster_shapes = [
        distribs.Discrete("shape", [s])
        for s in ["triangle", "square", "pentagon"]
    ]
    for shape in cluster_shapes:
        factors = distribs.Product([
            common_factors,
            cluster_colors,
            shape,
            distribs.Continuous("scale", 0.08, 0.12),
        ])
        sprite_gen_list.append(
            generators.generate_sprites(factors, num_sprites=2))

    goal_finding_colors = [
        distribs.Product([
            distribs.Continuous("c0", 192, 256, dtype="int32"),
            distribs.Continuous("c1", 0, 128, dtype="int32"),
            distribs.Continuous("c2", 64, 128, dtype="int32"),
        ]),
        distribs.Product([
            distribs.Continuous("c0", 0, 128, dtype="int32"),
            distribs.Continuous("c1", 192, 256, dtype="int32"),
            distribs.Continuous("c2", 64, 128, dtype="int32"),
        ]),
    ]
    goal_finding_positions = [(0.0, 0.5), (1.0, 0.5)]
    goal_finding_shapes = distribs.Discrete("shape", ["spoke_4", "star_4"])
    for colors in goal_finding_colors:
        factors = distribs.Product([
            common_factors,
            goal_finding_scale,
            goal_finding_shapes,
            colors,
        ])
        sprite_gen_list.append(generators.generate_sprites(
            factors, num_sprites=generators.RandInt(1, 3)))

    distractor_factors = distribs.Product([
        common_factors,
        distribs.Discrete("shape", ["circle"]),
        distribs.Continuous("c0", 64, 256, dtype="uint8"),
        distribs.Continuous("c1", 64, 256, dtype="uint8"),
        distribs.Continuous("c2", 64, 256, dtype="uint8"),
        distribs.Continuous("scale", 0.08, 0.12),
    ])
    sprite_gen_list.append(generators.generate_sprites(
        distractor_factors, num_sprites=generators.RandInt(0, 3)))

    sprite_gen = generators.shuffle(
        generators.chain_generators(*sprite_gen_list))

    task_list = [tasks.Clustering(
        cluster_shapes, terminate_bonus=0.0, reward_range=10.0)]
    for colors, goal_pos in zip(goal_finding_colors,
                                goal_finding_positions):
        task_list.append(tasks.FindGoalPosition(
            distribs.Product([colors, goal_finding_shapes]),
            goal_position=goal_pos,
            weights_dimensions=(1, 0),
            terminate_distance=0.15,
            raw_reward_multiplier=30))
    task = tasks.MetaAggregated(
        task_list, reward_aggregator="sum", termination_criterion="all")

    renderers = {
        "image": renderers_lib.ImageRenderer(
            image_size=(64, 64), anti_aliasing=5)
    }

    return {
        "task": task,
        "action_space": actions.SelectMove(scale=0.5),
        "renderers": renderers,
        "init_sprites": sprite_gen,
        "max_episode_length": 50,
        "metadata": {"name": "goal_finding_clustering.py", "mode": mode},
    }
