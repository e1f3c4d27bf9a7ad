"""COBRA task configs ported so far: the clustering task and the shared
definitions."""

from spriteworld_torch.configs.cobra import clustering
from spriteworld_torch.configs.cobra import common
