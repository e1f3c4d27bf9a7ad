"""COBRA clustering task: cluster sprites by hue.

Counterpart of `spriteworld_tpu/configs/cobra/clustering.py`: 4 hue
clusters (train = blue/green, test = red/yellow), 2 sprites per cluster in
a shuffled z-order, the Davies-Bouldin-based Clustering task, 50-step
episodes.
"""

from __future__ import annotations

from spriteworld_torch.configs.cobra import common
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import tasks

NUM_SPRITES_PER_CLUSTER = 2
MAX_EPISODE_LENGTH = 50

CLUSTERS_DISTS = {
    "red": ("c0", 0.9, 1.0),
    "blue": ("c0", 0.55, 0.65),
    "green": ("c0", 0.27, 0.37),
    "yellow": ("c0", 0.1, 0.2),
}

MODES = {
    "train": ("blue", "green"),
    "test": ("red", "yellow"),
}


def get_config(mode="train"):
    c0_clusters = [
        distribs.Continuous(*CLUSTERS_DISTS[name]) for name in MODES[mode]]

    other_factors = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Discrete("shape", ["square", "triangle", "circle"]),
        distribs.Discrete("scale", [0.13]),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])

    sprite_gen = generators.shuffle(generators.chain_generators(*[
        generators.generate_sprites(
            distribs.Product((other_factors, c0)), NUM_SPRITES_PER_CLUSTER)
        for c0 in c0_clusters
    ]))

    task = tasks.Clustering(c0_clusters, terminate_bonus=0.0,
                            reward_range=10.0)

    return {
        "task": task,
        "action_space": common.action_space(),
        "renderers": common.renderers(),
        "init_sprites": sprite_gen,
        "max_episode_length": MAX_EPISODE_LENGTH,
        "metadata": {"name": "clustering.py", "mode": mode},
    }
