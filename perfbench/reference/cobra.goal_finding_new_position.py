"""The reference of COBRA goal finding, new position (train mode).

Upstream: google-deepmind/spriteworld v1.0.2,
spriteworld/configs/cobra/goal_finding_new_position.py, the task of
arXiv:1905.09275. One target (hue in [0, 0.4)) whose position leaves out the
quadrant [0.5, 0.9)^2, one distractor (hue in [0.5, 0.9)), both square,
triangle or circle at scale 0.13; the target is to reach (0.5, 0.5) within
0.075; episodes of at most 20 steps; SelectMove(scale=0.25); a 64x64 HSV
image at anti_aliasing 5.
"""

from perfbench.reference import engine as e


def build(precision: str = "float32") -> e.Env:
    shared = e.Product([
        e.Discrete("shape", ["square", "triangle", "circle"]),
        e.Discrete("scale", [0.13]),
        e.Continuous("c1", 0.3, 1.0),
        e.Continuous("c2", 0.9, 1.0),
    ])
    target_hue = e.Continuous("c0", 0.0, 0.4)
    positions = e.SetMinus(
        e.Product([e.Continuous("x", 0.1, 0.9), e.Continuous("y", 0.1, 0.9)]),
        e.Product([e.Continuous("x", 0.5, 0.9), e.Continuous("y", 0.5, 0.9)]))
    target = e.Product([positions, target_hue, shared])
    distractor = e.Product([
        e.Continuous("x", 0.1, 0.9), e.Continuous("y", 0.1, 0.9),
        e.Continuous("c0", 0.5, 0.9), shared])
    scene = e.Shuffle(e.Chain(e.Generate(target, 1),
                              e.Generate(distractor, 1)))
    task = e.FindGoalPosition(target_hue, terminate_distance=0.075)
    return e.Env(scene, task, max_episode_length=20, precision=precision)
