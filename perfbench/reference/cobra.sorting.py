"""The reference of COBRA sorting (train mode).

Upstream: google-deepmind/spriteworld v1.0.2,
spriteworld/configs/cobra/sorting.py, the task of arXiv:1905.09275. Five
(hue range, goal corner) subtasks; an episode holds the sprites of one of
the ten pairs of subtasks, the first pair held out in train mode, one
sprite a subtask (square, triangle or circle at scale 0.13), in a shuffled
z-order. The reward is the NaN-ignoring sum of the subtasks' goal rewards
(multiplier 20, distance 0.075); an episode ends when every subtask
succeeds or after 50 steps. SelectMove(scale=0.25); a 64x64 HSV image at
anti_aliasing 5.
"""

import itertools

from perfbench.reference import engine as e

SUBTASKS = (
    ((0.9, 1.0), (0.75, 0.75)),
    ((0.55, 0.65), (0.75, 0.25)),
    ((0.27, 0.37), (0.25, 0.75)),
    ((0.73, 0.83), (0.25, 0.25)),
    ((0.1, 0.2), (0.5, 0.5)),
)


def build(precision: str = "float32") -> e.Env:
    tasks, gens = [], []
    for hue_range, goal in SUBTASKS:
        hue = e.Continuous("c0", *hue_range)
        tasks.append(e.FindGoalPosition(hue, goal_position=goal,
                                        terminate_distance=0.075,
                                        raw_reward_multiplier=20.0))
        gens.append(e.Generate(e.Product([
            hue,
            e.Continuous("x", 0.1, 0.9),
            e.Continuous("y", 0.1, 0.9),
            e.Discrete("shape", ["square", "triangle", "circle"]),
            e.Discrete("scale", [0.13]),
            e.Continuous("c1", 0.3, 1.0),
            e.Continuous("c2", 0.9, 1.0),
        ]), 1))
    pairs = list(itertools.combinations(range(len(SUBTASKS)), 2))[1:]
    scene = e.Shuffle(e.SampleGenerator(
        [e.Chain(*[gens[i] for i in pair]) for pair in pairs]))
    return e.Env(scene, e.MetaAggregated(tasks), max_episode_length=50,
                 precision=precision)
