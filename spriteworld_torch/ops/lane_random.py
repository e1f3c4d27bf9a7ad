"""Per-lane random keys: the key contract of `jax.random` on tensors.

Counterpart of what the JAX package takes from `jax.random` (`key`,
`split`, `fold_in`, `key_data`, `wrap_key_data` and the draws). A key is
the raw data of a threefry2x32 key: two 32-bit words, held as
int32[..., 2] with the bits that `jax.random.key_data` gives as
uint32[..., 2] (torch's uint32 arithmetic is partial on the card). Every
function maps each lane's key (the leading axes) to that lane's outputs,
so a lane's draws depend on its key alone, not on the other lanes nor on
how many lanes a call holds.

One primitive does everything: T(key, j) = threefry2x32-20(key, (0, j)),
the block of counter j. With `jax_threefry_partitionable` (JAX's default
since 0.5) `jax.random` computes

  split(key, n)[j] = T(key, j)          (a key)
  fold_in(key, d)  = T(key, d)          (a key)
  bits(key, n)[j]  = T(key, j)[0] ^ T(key, j)[1]
  uniform          = float32 of (bits >> 9) | 0x3F800000, minus 1, times
                     (hi - lo) plus lo in one fused multiply-add (as XLA
                     contracts it), at least lo

and these functions return the same words and floats. `randint` and
`normal` are the port's own draws on those bits (JAX's sampled integers
and normals are not reproduced): `randint` is lo + bits mod (hi - lo),
`normal` is sqrt(2) erfinv(u) of JAX's uniform u on (-1, 1), taken in
float64 and rounded once, so the card and the CPU agree.

On a CUDA tensor one launch of `csrc/lane_random.cu` computes the blocks
of every lane and counter and writes keys, bits, uniform floats, integers
or normals (`threefry_launch`, which counts its launches); on a CPU tensor
the plain twin does the same with int64 torch operations masked to 32
bits (`threefry_plain`). Neither syncs with the host, so a draw can be
captured in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from spriteworld_torch.ops import _build

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Output modes of the kernel and of its plain twin.
KEYS, BITS, UNIFORM, RANDINT, NORMAL = range(5)
MODE_NAMES = ("keys", "bits", "uniform", "randint", "normal")

# JAX's normal draws its uniform on [nextafter(-1, 0), 1).
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _f32(x) -> float:
    """`x` rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(x))


# ---------------------------------------------------------------------- #
# Keys on the host.

def key(seed, device="cpu") -> torch.Tensor:
    """The key of an integer seed, int32[2] on `device`: the words of
    `jax.random.key(seed)`. A seed in int32 range takes JAX's rule with
    x64 off, (0, seed mod 2**32); a larger one (below 2**64) is split into
    its high and low words, as JAX with x64 on does. The words are
    filled in on the device: no host-to-device copy, no wait."""
    seed = int(seed)
    if -2**31 <= seed < 2**31:
        words = (0, seed & MASK)
    elif 0 <= seed < 2**64:
        words = (seed >> 32, seed & MASK)
    else:
        raise ValueError(f"seed {seed} is neither in int32 range nor in "
                         "[0, 2**64)")
    hi, lo = (w - (w >> 31 << 32) for w in words)  # the words as int32
    out = torch.full((2,), lo, dtype=torch.int32, device=device)
    out[:1].fill_(hi)
    return out


def key_data(keys: torch.Tensor) -> np.ndarray:
    """The words of `keys` as host uint32[..., 2]: what
    `jax.random.key_data` gives for the same keys."""
    return keys.detach().cpu().contiguous().numpy().view(np.uint32)


def wrap_key_data(data, device="cpu") -> torch.Tensor:
    """Keys from their words (uint32[..., 2], e.g. `jax.random.key_data`
    of a JAX key), as int32[..., 2] on `device`."""
    data = np.ascontiguousarray(np.asarray(data))
    if data.shape[-1:] != (2,):
        raise ValueError(f"key data has shape {data.shape}; the last axis "
                         "holds the two words")
    words = data.astype(np.uint32) if data.dtype != np.int32 else data
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def as_key(seed_or_key, device) -> torch.Tensor:
    """One key on `device`: an int is a seed (`key`), a tensor a key."""
    if isinstance(seed_or_key, torch.Tensor):
        if seed_or_key.shape != (2,):
            raise ValueError(f"a key is int32[2], got "
                             f"{tuple(seed_or_key.shape)}")
        return seed_or_key.to(device=device, dtype=torch.int32)
    return key(seed_or_key, device)


# ---------------------------------------------------------------------- #
# The plain twin.

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def _threefry_blocks(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 with 20 rounds on int64 tensors of 32-bit words (any
    broadcastable shapes); returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c of float32 `a` and float32-valued `b`, `c`, rounded once
    to float32 (a fused multiply-add): the product is exact in float64,
    the sum's rounding error is found exactly (TwoSum) and folded into the
    last bit (round to odd), so the one rounding to float32 is correct."""
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where(inexact, torch.nextafter(s, toward), s)
    return s.float()


def _as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) as int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def threefry_plain(keys: torch.Tensor, n: int, mode: int, start: int = 0,
                   counters_first: bool = False, lo=0.0, hi=1.0):
    """The plain torch twin of `threefry_launch` (same arguments, same
    result), for keys on any device."""
    lanes = keys.shape[:-1]
    flat = keys.reshape(-1, 2).to(torch.int64) & MASK
    j = torch.arange(start, start + n, dtype=torch.int64,
                     device=keys.device)
    if counters_first:
        k0, k1, x1 = flat[None, :, 0], flat[None, :, 1], j[:, None]
        out_shape = (n,) + tuple(lanes)
    else:
        k0, k1, x1 = flat[:, 0, None], flat[:, 1, None], j[None, :]
        out_shape = tuple(lanes) + (n,)
    y0, y1 = _threefry_blocks(k0, k1, torch.zeros_like(x1), x1)
    if mode == KEYS:
        return _as_i32(torch.stack([y0, y1], -1)).reshape(out_shape + (2,))
    b = y0 ^ y1
    if mode == BITS:
        out = _as_i32(b)
    elif mode in (UNIFORM, NORMAL):
        if mode == NORMAL:
            lo, hi = _NORMAL_LO, 1.0
        lo, span = _f32(lo), _f32(_f32(hi) - _f32(lo))
        f = _as_i32((b >> 9) | 0x3F800000).view(torch.float32) - 1.0
        out = _fma_f32(f, span, lo).clamp_min(lo)
        if mode == NORMAL:
            out = (torch.erfinv(out.double()) * math.sqrt(2.0)).float()
    elif mode == RANDINT:
        lo, hi = int(lo), int(hi)
        out = (b % (hi - lo) + lo).to(torch.int32)
    else:
        raise ValueError(f"unknown mode {mode}")
    return out.reshape(out_shape)


# ---------------------------------------------------------------------- #
# The kernel.

@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, lane_random_launch typed, the current stream's handle of
    a card by index). The handle comes from torch's raw-stream query where
    torch has it (no Stream object a launch: a step draws ~30-200 times),
    else from `torch.cuda.current_stream`."""
    lib = _build.load("lane_random")
    fn = lib.lane_random_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda index: torch.cuda.current_stream(index).cuda_stream)
    return lib, fn, stream


def _lanes_view(keys: torch.Tensor) -> torch.Tensor:
    """`keys` as [L, 2] with unit word stride: a view where the lanes
    flatten to one stride, else a copy."""
    flat = keys.reshape(-1, 2)
    if flat.stride(1) != 1 or (flat.shape[0] > 1 and flat.stride(0) < 2):
        flat = flat.contiguous()
    return flat


def threefry_launch(keys: torch.Tensor, n: int, mode: int, start: int = 0,
                    counters_first: bool = False, lo=0.0, hi=1.0):
    """One launch of `csrc/lane_random.cu` over CUDA keys int32[*S, 2]:
    the blocks T(key, start + j), j < n, of every lane, written as keys
    (int32[*S, n, 2]), bits (int32[*S, n]), uniform floats on [lo, hi)
    (float32[*S, n]), integers in [lo, hi) (int32[*S, n]) or standard
    normals (float32[*S, n], `normal`'s construction); with
    `counters_first` the counter axis leads ([n, *S, ...]). Runs on the
    current stream; raises when the kernel cannot launch. Each launch adds
    one to `threefry_launch.launches` and `.by_mode[MODE_NAMES[mode]]`."""
    if not keys.is_cuda:
        raise ValueError("threefry_launch needs CUDA keys; CPU keys use "
                         "threefry_plain")
    if keys.dtype != torch.int32 or keys.shape[-1:] != (2,):
        raise ValueError(f"keys must be int32[..., 2], got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if start < 0 or start + n > 2**32:
        raise ValueError(f"counters [{start}, {start + n}) leave uint32")
    lanes = tuple(keys.shape[:-1])
    count = math.prod(lanes)
    head = ((n,) + lanes) if counters_first else (lanes + (n,))
    if mode == KEYS:
        out = torch.empty(head + (2,), dtype=torch.int32, device=keys.device)
    else:
        out = torch.empty(head, device=keys.device, dtype=(
            torch.float32 if mode in (UNIFORM, NORMAL) else torch.int32))
    if count == 0 or n == 0:
        return out
    flat = _lanes_view(keys)
    lo_f = span_f = 0.0
    lo_i = span_u = 0
    if mode in (UNIFORM, NORMAL):
        if mode == NORMAL:
            lo, hi = _NORMAL_LO, 1.0
        lo_f, span_f = _f32(lo), _f32(_f32(hi) - _f32(lo))
    elif mode == RANDINT:
        lo_i, span_u = int(lo), int(hi) - int(lo)
        if not (0 < span_u and -2**31 <= lo_i and lo_i + span_u <= 2**31):
            raise ValueError(f"randint range [{lo}, {hi}) out of range")
    lib, launch, current_stream = _launcher()
    current = torch.cuda.current_device()
    index = current if keys.device.index is None else keys.device.index
    # Switching to the keys' card costs host time: only where needed.
    with (contextlib.nullcontext() if index == current
          else torch.cuda.device(index)):
        err = launch(flat.data_ptr(), count, flat.stride(0), n, start, mode,
                     int(counters_first), lo_f, span_f, lo_i, span_u,
                     out.data_ptr(), current_stream(index))
    if err != 0:
        raise RuntimeError(f"lane_random kernel failed to launch: CUDA "
                           f"error {err} ({_build.error_string(lib, err)})")
    threefry_launch.launches += 1
    name = MODE_NAMES[mode]
    threefry_launch.by_mode[name] = threefry_launch.by_mode.get(name, 0) + 1
    return out


def reset_launch_counts():
    """Set the kernel wrapper's launch counts to 0."""
    threefry_launch.launches = 0
    threefry_launch.by_mode = {}


reset_launch_counts()


def _threefry(keys, n, mode, start=0, counters_first=False, lo=0.0,
              hi=1.0):
    fn = threefry_launch if keys.is_cuda else threefry_plain
    return fn(keys, n, mode, start, counters_first, lo, hi)


# ---------------------------------------------------------------------- #
# The jax.random counterparts, per lane.

def split(keys: torch.Tensor, n=2, start: int = 0,
          counters_first: bool = False) -> torch.Tensor:
    """int32[*S, n, 2]: `jax.random.split(key, n)` of each lane's key
    (with `start`, the keys start..start+n-1 of a longer split: a slice of
    the lanes of `split(key, N)`). `counters_first` puts the new axis
    first: [n, *S, 2]. A shape `n` splits as JAX splits into a shape:
    `split(keys, prod(n))` with the new axis unflattened to `n`."""
    if isinstance(n, tuple):
        out = _threefry(keys, math.prod(n), KEYS, start)
        return out.reshape(tuple(keys.shape[:-1]) + n + (2,))
    return _threefry(keys, n, KEYS, start, counters_first)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """int32[*S, 2]: `jax.random.fold_in(key, data)` of each lane's key."""
    if not 0 <= int(data) < 2**32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    return _threefry(keys, 1, KEYS, int(data))[..., 0, :]


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int32[*S, n]: `jax.random.bits(key, (n,), uint32)` of each lane's
    key, the uint32 words held as int32."""
    return _threefry(keys, n, BITS)


def uniform(keys: torch.Tensor, n: int = 1, lo=0.0, hi=1.0) -> torch.Tensor:
    """float32[*S, n]: `jax.random.uniform(key, (n,), float32, lo, hi)`
    of each lane's key."""
    return _threefry(keys, n, UNIFORM, lo=lo, hi=hi)


def randint(keys: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """int32[*S, n] in [lo, hi): lo + bits mod (hi - lo) of each lane's
    key (a bias of at most (hi - lo) / 2**32; JAX's randint draws other
    values)."""
    return _threefry(keys, n, RANDINT, lo=lo, hi=hi)


def normal(keys: torch.Tensor, n: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[*S, n] standard normals, float32 then cast to `dtype`: sqrt(2)
    erfinv(u) of JAX's uniform u on [nextafter(-1, 0), 1)
    (`jax.random.normal`'s construction), taken in float64 and rounded
    once, so the card and the CPU agree but where their float64 erfinv
    differ across a float32 rounding boundary."""
    return _threefry(keys, n, NORMAL).to(dtype)
