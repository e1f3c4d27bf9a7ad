"""The reference of Spriteworld's compositional example, goal finding and
clustering (train mode).

Upstream: google-deepmind/spriteworld v1.0.2,
spriteworld/configs/examples/goal_finding_clustering.py. Every sprite has
x, y in [0.1, 0.9) and an integer angle in [0, 360). Three clusters of
2 sprites each, triangles, squares and pentagons at scale [0.08, 0.12),
coloured (c0, c1, c2) with c0 in [128, 256) and c1, c2 in [64, 256), all
integers; two goal-finding groups of RandInt(1, 3) sprites each, spoke_4
or star_4, at a scale in [0.05, 0.15) less [0.08, 0.12) (rejection),
reddish (c0 [192, 256), c1 [0, 128), c2 [64, 128)) and greenish (c0
[0, 128), c1 [192, 256), c2 [64, 128)); RandInt(0, 3) circles at scale
[0.08, 0.12), colours in [64, 256) as uint8. The six groups are chained
into 12 slots (8 to 12 live) in a shuffled z-order. The reward is the sum
of a Clustering task over the three shapes (reward_range 10, threshold
2.5) and two x-only goal tasks (weights (1, 0)) bringing each goal group
to x = 0 and x = 1 (multiplier 30, distance 0.15); an episode ends when
all three succeed or after 50 steps. SelectMove(scale=0.5); a 64x64 image
at anti_aliasing 5 with the colours as given (RGB, no HSV map).

Departures from upstream are those of `compositional` and `engine`: the
state is float32.
"""

from perfbench.reference import compositional as c
from perfbench.reference import engine as e


def build(precision: str = "float32") -> c.Env:
    common = e.Product([
        e.Continuous("x", 0.1, 0.9),
        e.Continuous("y", 0.1, 0.9),
        c.IntContinuous("angle", 0, 360),
    ])
    green_blue = e.Product([c.IntContinuous("c1", 64, 256),
                            c.IntContinuous("c2", 64, 256)])
    cluster_colors = e.Product([c.IntContinuous("c0", 128, 256),
                                green_blue])
    cluster_shapes = [e.Discrete("shape", c.shape_ids([s]))
                      for s in ("triangle", "square", "pentagon")]
    gens = [e.Generate(e.Product([common, cluster_colors, shape,
                                  e.Continuous("scale", 0.08, 0.12)]), 2)
            for shape in cluster_shapes]

    goal_scale = e.SetMinus(e.Continuous("scale", 0.05, 0.15),
                            e.Continuous("scale", 0.08, 0.12))
    goal_shapes = e.Discrete("shape", c.shape_ids(["spoke_4", "star_4"]))
    goal_colors = [
        e.Product([c.IntContinuous("c0", 192, 256),
                   c.IntContinuous("c1", 0, 128),
                   c.IntContinuous("c2", 64, 128)]),
        e.Product([c.IntContinuous("c0", 0, 128),
                   c.IntContinuous("c1", 192, 256),
                   c.IntContinuous("c2", 64, 128)]),
    ]
    gens += [c.RandGenerate(e.Product([common, goal_scale, goal_shapes,
                                       colors]), 1, 3)
             for colors in goal_colors]
    distractors = e.Product([
        common,
        e.Discrete("shape", c.shape_ids(["circle"])),
        c.IntContinuous("c0", 64, 256),
        c.IntContinuous("c1", 64, 256),
        c.IntContinuous("c2", 64, 256),
        e.Continuous("scale", 0.08, 0.12),
    ])
    gens.append(c.RandGenerate(distractors, 0, 3))
    scene = e.Shuffle(e.Chain(*gens))

    tasks = [c.Clustering(cluster_shapes, reward_range=10.0)]
    for colors, goal in zip(goal_colors, [(0.0, 0.5), (1.0, 0.5)]):
        tasks.append(c.FindGoalPosition(
            e.Product([colors, goal_shapes]), weights_dimensions=(1, 0),
            goal_position=goal, terminate_distance=0.15,
            raw_reward_multiplier=30.0))
    return c.Env(scene, c.MetaAggregated(tasks), max_episode_length=50,
                 move_scale=0.5, precision=precision)
