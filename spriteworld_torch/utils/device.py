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


def to_host(tensors: dict) -> dict:
    """Numpy copies of a dict of tensors on one device, in one transfer.

    The tensors' bytes are gathered into one buffer on their device, copied
    to the host once (the only wait for the device), and viewed back as
    arrays of each tensor's shape and dtype. Each piece starts on an
    8-byte boundary so that every view is aligned.
    """
    pieces, layout, offset = [], [], 0
    for name, t in tensors.items():
        raw = t.detach().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        pieces += [raw, raw.new_zeros(pad)]
        layout.append((name, offset, raw.numel(), tuple(t.shape), t.dtype))
        offset += raw.numel() + pad
    if not pieces:
        return {}
    host = torch.cat(pieces).cpu().numpy()
    return {name: host[start:start + size].view(numpy_dtype(dtype))
            .reshape(shape)
            for name, start, size, shape, dtype in layout}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bool, integer or float)."""
    return np.dtype(str(dtype).removeprefix("torch."))
