"""Pillow-exact Lanczos downsampling.

Counterpart of `spriteworld_tpu/ops/resample.py`. The reference downsamples
its supersampled canvas with ``Image.resize(image_size, Image.ANTIALIAS)``:
Pillow's separable Lanczos-3 filter in fixed point — a horizontal pass, a
clip to uint8, then a vertical pass.

Taps are computed on the host in float64 exactly as Pillow's
``precompute_coeffs`` does and quantized to Pillow's 22-bit fixed point, so
each tap is an integer ``q`` over ``2**22``. Pillow accumulates ``sum(q * p)``
in int32 and rounds with ``clip8((sum + 2**21) >> 22)``. This module does the
same sum with integer taps in float64: every partial sum is an integer far
below 2**53, so the result is exact whatever the summation order, and equals
Pillow's on every value. (The JAX package sums ``q / 2**22 * p`` in float32,
which differs from Pillow by 1 on rare values.)
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from spriteworld_torch.utils import device as device_lib

# Pillow Resample.c: PRECISION_BITS = 32 - 8 - 2.
PRECISION_BITS = 22
_LANCZOS_SUPPORT = 3.0


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's lanczos_filter: sinc(x) * sinc(x/3) on [-3, 3)."""
    out = np.sinc(x) * np.sinc(x / 3.0)
    return np.where((x >= -3.0) & (x < 3.0), out, 0.0)


@functools.lru_cache(maxsize=None)
def pil_lanczos_fixed(in_size: int,
                      out_size: int) -> Tuple[np.ndarray, Tuple[np.ndarray]]:
    """Pillow's integer taps: (xmin i32[out_size], taps per output).

    Follows Pillow's precompute_coeffs (Resample.c) with in0=0,
    in1=in_size, then normalize_coeffs_8bpc (round half away from zero of
    k * 2^22). Output `o` reads inputs xmin[o] .. xmin[o] + len(taps[o]).
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale

    xmins, taps_all = [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = _lanczos((np.arange(xmin, xmax) - center + 0.5) * ss)
        total = taps.sum()
        if total != 0.0:
            taps = taps / total
        q = np.where(taps < 0,
                     np.trunc(taps * (1 << PRECISION_BITS) - 0.5),
                     np.trunc(taps * (1 << PRECISION_BITS) + 0.5))
        xmins.append(xmin)
        taps_all.append(q.astype(np.int64))
    return np.asarray(xmins, np.int32), tuple(taps_all)


@functools.lru_cache(maxsize=None)
def pil_lanczos_matrix_q(in_size: int, out_size: int) -> np.ndarray:
    """i64[out_size, in_size] dense integer taps (Pillow's q values)."""
    xmins, taps = pil_lanczos_fixed(in_size, out_size)
    mat = np.zeros((out_size, in_size), np.int64)
    for o, (xmin, q) in enumerate(zip(xmins, taps)):
        mat[o, xmin:xmin + len(q)] = q
    return mat


def pil_lanczos_matrix(in_size: int, out_size: int) -> np.ndarray:
    """f32[out_size, in_size] of Pillow-quantized taps q / 2^22.

    The same values as the JAX package's matrix (each is exact in float32).
    """
    q = pil_lanczos_matrix_q(in_size, out_size)
    return (q.astype(np.float64) / (1 << PRECISION_BITS)).astype(np.float32)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow clip8 on an integer-valued float64 accumulator of q * p."""
    half = float(1 << (PRECISION_BITS - 1))
    inv = 1.0 / (1 << PRECISION_BITS)  # power of two: the product is exact
    return torch.floor((acc + half) * inv).clamp(0.0, 255.0)


def lanczos_h(canvas: torch.Tensor, out_w: int) -> torch.Tensor:
    """Pillow's horizontal Lanczos pass of [..., H, W, C] integer values in
    0..255, with its uint8 rounding -> u8[..., H, out_w, C]."""
    kw = device_lib.constant(
        pil_lanczos_matrix_q(canvas.shape[-2], out_w).astype(np.float64),
        canvas.device)
    return _clip8(torch.einsum("ow,...hwc->...hoc", kw,
                               canvas.to(torch.float64))).to(torch.uint8)


def lanczos_v(rows: torch.Tensor, out_h: int) -> torch.Tensor:
    """Pillow's vertical Lanczos pass of [..., H, W, C] -> u8[..., out_h, W,
    C] (rows stay in Pillow's order: top row first)."""
    kh = device_lib.constant(
        pil_lanczos_matrix_q(rows.shape[-3], out_h).astype(np.float64),
        rows.device)
    return _clip8(torch.einsum("oh,...hwc->...owc", kh,
                               rows.to(torch.float64))).to(torch.uint8)


def pil_resize_lanczos(canvas: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Pillow ANTIALIAS resize of [..., H, W, C] integer values in 0..255.

    Horizontal pass, uint8 rounding, then vertical pass — Pillow's order.
    Returns u8[..., out_h, out_w, C], equal to Pillow's result.
    """
    return lanczos_v(lanczos_h(canvas, out_w), out_h)
