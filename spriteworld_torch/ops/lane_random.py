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

and these functions return the same words and floats. The draws built
on them are `jax.random`'s too:

  randint(key, n, lo, hi)[j]  from the halves k1, k2 = split(key): with
                     a = bits(k1)[j], b = bits(k2)[j] and span = hi - lo
                     (1 where hi <= lo), lo + ((a % span) * m + b % span)
                     % span in uint32, m = (2**16 % span)**2 % span
  choice(key, n, c)  searchsorted(c, c[-1] * (1 - uniform(key)), left) of
                     the float32 cumulative sum c of the probabilities
  split_chain(key, n)  the keys of n rounds of `k, sub = split(k)`, the
                     chain of JAX's rejection loop, and the k after them
  normal             sqrt(2) erf_inv(u) of the uniform u on
                     [nextafter(-1, 0), 1), with XLA's float32 ErfInv32:
                     its two polynomials in w = -log1p(-u*u) by fused
                     multiply-adds, log1p taken in float64 and rounded once
                     (XLA's float32 log1p on the CPU can differ from that
                     by an ulp, so a normal is within a few float32 ulps of
                     JAX's on the CPU and most are equal;
                     tests/test_torch_seeded_parity.py counts them).

On a CUDA tensor one launch of `csrc/lane_random.cu` computes the blocks
of every lane and counter and writes keys, bits, uniform floats, integers,
normals or a key chain (`threefry_launch`, which counts its launches); on a
CPU tensor the plain twin does the same with int64 torch operations masked
to 32 bits (`threefry_plain`). Neither syncs with the host, so a draw can be
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
from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils import profiling

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Output modes of the kernel and of its plain twin.
KEYS, BITS, UNIFORM, RANDINT, NORMAL, CHAIN = range(6)
MODE_NAMES = ("keys", "bits", "uniform", "randint", "normal", "chain")
# Threefry blocks an output of each mode computes: randint the two halves
# of the key and a block of each; the chain two blocks a round.
BLOCKS_PER_OUTPUT = (1, 1, 1, 4, 1, 2)

# JAX's normal draws its uniform on [nextafter(-1, 0), 1).
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's ErfInv32: the polynomial coefficients for w < 5 and for w >= 5,
# highest degree first (csrc/lane_random.cu holds the same).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_INT32_MAX = 2**31 - 1


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


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c of float32 `a` and float32-valued `b`, `c` (floats or
    float32 tensors), rounded once to float32 (a fused multiply-add): the
    product is exact in float64, the sum's rounding error is found exactly
    (TwoSum) and folded into the last bit (round to odd), so the one
    rounding to float32 is correct."""
    b, c = (v.double() if isinstance(v, torch.Tensor) else v for v in (b, c))
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


def randint_range(lo, hi) -> Tuple[int, int]:
    """(lo, span) of `jax.random.randint`'s int32 range [lo, hi): span =
    hi - lo as a uint32 word, 1 where hi <= lo. Bounds outside int32 raise
    OverflowError, as JAX's (x64 off) do."""
    lo, hi = int(lo), int(hi)
    if not (-2**31 <= lo <= _INT32_MAX and -2**31 <= hi <= _INT32_MAX):
        raise OverflowError(f"randint bounds [{lo}, {hi}) leave int32")
    return lo, (hi - lo if hi > lo else 1)


def _randint_fold(a: torch.Tensor, b: torch.Tensor, lo: int, span: int):
    """int32 lo + ((a % span) * m + b % span) % span, uint32 arithmetic
    on int64 words, m = (2**16 % span)**2 % span with the square wrapped
    in uint32: `jax.random.randint`'s fold of its high words a and low
    words b."""
    m = (1 << 16) % span
    m = ((m * m) & MASK) % span
    hi_r = a % span
    # (hi_r * m) mod 2**32 by 16-bit halves of m: no int64 overflow.
    prod = (hi_r * (m & 0xFFFF) + (((hi_r * (m >> 16)) & 0xFFFF) << 16)) & MASK
    offset = ((prod + b % span) & MASK) % span
    return _as_i32(((lo & MASK) + offset) & MASK)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv32 of float32 `x`: w = -log1p(-x*x) (log1p in
    float64, rounded once), w - 2.5 (w < 5) or sqrt(w) - 3, the Horner
    loop of fused multiply-adds over the coefficients of its w range,
    times x; +-inf where |x| == 1."""
    w = -torch.log1p((x * -x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = [torch.where(lt, _f32(a), _f32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0].expand_as(w)
    for c in coef[1:]:
        p = _fma_f32(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _chain_plain(flat: torch.Tensor, n: int, counters_first: bool):
    """The split chain of int64 keys [L, 2]: sub_r = T(s_r, 1), s_{r+1} =
    T(s_r, 0), s_0 the key; [L, n + 1, 2] of sub_0..sub_{n-1}, s_n (or
    [n + 1, L, 2] counters first)."""
    j = torch.arange(2, dtype=torch.int64, device=flat.device)
    s, out = flat, []
    for _ in range(n):
        y0, y1 = _threefry_blocks(s[:, 0, None], s[:, 1, None],
                                  torch.zeros_like(j), j)
        out.append(torch.stack([y0[:, 1], y1[:, 1]], -1))
        s = torch.stack([y0[:, 0], y1[:, 0]], -1)
    out.append(s)
    return _as_i32(torch.stack(out, 0 if counters_first else 1))


def threefry_plain(keys: torch.Tensor, n: int, mode: int, start: int = 0,
                   counters_first: bool = False, lo=0.0, hi=1.0):
    """The plain torch twin of `threefry_launch` (same arguments, same
    result), for keys on any device. It counts what the kernel's launch
    would into the census of a graph being captured
    (`utils.profiling.count`)."""
    lanes = tuple(keys.shape[:-1])
    if n and math.prod(lanes):
        profiling.count("lane_random", MODE_NAMES[mode],
                        math.prod(lanes) * n * BLOCKS_PER_OUTPUT[mode])
    flat = keys.reshape(-1, 2).to(torch.int64) & MASK
    if mode == CHAIN:
        out = _chain_plain(flat, n, counters_first)
        head = ((n + 1,) + lanes) if counters_first else (lanes + (n + 1,))
        return out.reshape(head + (2,))
    j = torch.arange(start, start + n, dtype=torch.int64,
                     device=keys.device)
    if counters_first:
        k0, k1, x1 = flat[None, :, 0], flat[None, :, 1], j[:, None]
        out_shape = (n,) + lanes
    else:
        k0, k1, x1 = flat[:, 0, None], flat[:, 1, None], j[None, :]
        out_shape = lanes + (n,)
    if mode == RANDINT:
        # The halves k1 = T(key, 0) and k2 = T(key, 1) on a last axis,
        # then the bits of each at the counters.
        half = torch.arange(2, dtype=torch.int64, device=keys.device)
        h0, h1 = _threefry_blocks(k0[..., None], k1[..., None],
                                  torch.zeros_like(half), half)
        y0, y1 = _threefry_blocks(h0, h1, torch.zeros_like(x1)[..., None],
                                  x1[..., None])
        y = y0 ^ y1
        lo, span = randint_range(lo, hi)
        return _randint_fold(y[..., 0], y[..., 1], lo,
                             span).reshape(out_shape)
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
            out = _erfinv32(out) * _SQRT2_F32
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
    (float32[*S, n]), `jax.random.randint`'s integers in [lo, hi)
    (int32[*S, n]) or standard normals (float32[*S, n], `normal`'s
    construction); or the split chain of each lane's key (int32[*S, n + 1,
    2], `split_chain`; `start` unused). With `counters_first` the counter
    axis leads ([n, *S, ...]). Runs on the current stream; raises when the
    kernel cannot launch. Each launch adds one to
    `threefry_launch.launches` and `.by_mode[MODE_NAMES[mode]]`, and the
    launch with its threefry blocks to the census of a graph being
    captured (`utils.profiling.count`)."""
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
    rows = n + 1 if mode == CHAIN else n
    head = ((rows,) + lanes) if counters_first else (lanes + (rows,))
    if mode in (KEYS, CHAIN):
        out = torch.empty(head + (2,), dtype=torch.int32, device=keys.device)
    else:
        out = torch.empty(head, device=keys.device, dtype=(
            torch.float32 if mode in (UNIFORM, NORMAL) else torch.int32))
    if mode == CHAIN and count and n == 0:
        return out.copy_(keys.reshape(head + (2,)))
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
        lo_i, span_u = randint_range(lo, hi)
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
    profiling.count("lane_random", name, count * n * BLOCKS_PER_OUTPUT[mode])
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
    """int32[*S, n]: `jax.random.randint(key, (n,), lo, hi)` of each
    lane's key (int32 bounds, clipped as JAX clips them; lo where hi <=
    lo)."""
    return _threefry(keys, n, RANDINT, lo=lo, hi=hi)


def cumulative(probs) -> np.ndarray:
    """float32 cumulative sums of `probs` taken in float32 one after the
    other, unnormalized: `jnp.cumsum` of the probabilities as JAX's
    `choice` takes it (with x64 off)."""
    return np.cumsum(np.asarray(probs, np.float32), dtype=np.float32)


def choice(keys: torch.Tensor, n: int, cum: np.ndarray) -> torch.Tensor:
    """int64[*S, n]: `jax.random.choice(key, len(p), (n,), p=p)` of each
    lane's key, `cum` being `cumulative(p)`: the first index whose
    cumulative sum reaches cum[-1] * (1 - u) of JAX's uniform u. No check
    on the host (like `torch.multinomial`'s), so a draw can be captured."""
    c = device_lib.constant(cum, keys.device)
    u = uniform(keys, n)
    return torch.searchsorted(c, (1.0 - u) * _f32(cum[-1]), side="left")


def split_chain(keys: torch.Tensor, n: int):
    """(subkeys int32[n, *S, 2], state int32[*S, 2]): the keys of n
    rounds of `k, sub = jax.random.split(k)` from each lane's key, the
    chain of JAX's rejection loop (sub_r = split(s_r)[1], s_{r+1} =
    split(s_r)[0], s_0 = the key), and the state s_n that continues it."""
    out = _threefry(keys, n, CHAIN, counters_first=True)
    return out[:n], out[n]


def normal(keys: torch.Tensor, n: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[*S, n] standard normals, float32 then cast to `dtype`:
    `jax.random.normal`'s float32(sqrt 2) * erf_inv(u) of its uniform u on
    [nextafter(-1, 0), 1), with XLA's float32 ErfInv32 (log1p in float64,
    rounded once; see the module docstring)."""
    return _threefry(keys, n, NORMAL).to(dtype)
