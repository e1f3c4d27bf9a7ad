"""Task configs: declarative `get_config(mode) -> Environment kwargs` modules.

Counterpart of `spriteworld_tpu/configs`, for the configs ported so far:
every module exposes ``get_config(mode)`` returning a dict whose keys match
``core.environment.Environment.__init__``.
"""

from spriteworld_torch.configs import cobra
