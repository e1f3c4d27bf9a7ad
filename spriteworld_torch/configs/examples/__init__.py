"""Example task configs."""

from spriteworld_torch.configs.examples import goal_finding_clustering
from spriteworld_torch.configs.examples import goal_finding_embodied
