"""Task configs: declarative `get_config(mode) -> Environment kwargs` modules.

Counterpart of `spriteworld_tpu/configs`: every module exposes
``get_config(mode)`` returning a dict whose keys match
``core.environment.Environment.__init__``.
"""

from spriteworld_torch.configs import cobra
from spriteworld_torch.configs import examples
