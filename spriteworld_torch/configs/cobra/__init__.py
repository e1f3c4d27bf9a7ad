"""COBRA task configs."""

from spriteworld_torch.configs.cobra import clustering
from spriteworld_torch.configs.cobra import common
from spriteworld_torch.configs.cobra import exploration
from spriteworld_torch.configs.cobra import goal_finding_more_distractors
from spriteworld_torch.configs.cobra import goal_finding_more_targets
from spriteworld_torch.configs.cobra import goal_finding_new_position
from spriteworld_torch.configs.cobra import goal_finding_new_shape
from spriteworld_torch.configs.cobra import sorting
