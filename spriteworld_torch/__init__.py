"""spriteworld_torch — the PyTorch/CUDA port of spriteworld_tpu.

The same engine as the JAX package beside it — factor-tensor state, scene
samplers, action spaces, tasks and a Pillow-exact rasterizer — on torch
tensors with a leading batch axis. The rasterizer's scene kernel is
hand-written CUDA for Hopper (`csrc/`); every kernel has a plain PyTorch
version beside it, which CPU tensors take. Entry points take a `device`
argument that defaults to "cuda".
"""

__version__ = "0.1.0"
