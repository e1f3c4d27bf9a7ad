"""Device resolution for the port's entry points."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device for `device`; raises when CUDA is asked for and absent.

    Entry points default to "cuda" and never carry on on the CPU in its
    place: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU.")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(array_bytes: bytes, dtype: str, shape: tuple,
              device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.frombuffer(array_bytes, dtype=dtype).reshape(shape).copy()
    ).to(device)


def constant(array: np.ndarray, device) -> torch.Tensor:
    """A host constant as a tensor on `device`, cached per (value, device)."""
    a = np.ascontiguousarray(array)
    return _constant(a.tobytes(), a.dtype.str, a.shape, torch.device(device))
