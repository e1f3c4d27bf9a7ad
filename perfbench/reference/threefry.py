"""`jax.random`'s threefry key contract in plain NumPy.

A key is uint32[..., 2], the words `jax.random.key_data` gives. With
`jax_threefry_partitionable` (JAX's default) every draw is built on one
block, T(key, j) = threefry2x32-20(key, counter (0, j)):

  split(key, n)[j] = T(key, j)
  fold_in(key, d)  = T(key, d)
  bits(key, n)[j]  = T(key, j)[0] ^ T(key, j)[1]
  uniform          float32 of (bits >> 9) | 0x3F800000, minus 1, times
                   (hi - lo) plus lo rounded once (a fused multiply-add),
                   at least lo
  randint          from the halves T(key, 0) and T(key, 1): a = bits of
                   the first, b = bits of the second, lo + ((a % span) * m
                   + b % span) % span in uint32, m = (2**16 % span)**2 %
                   span wrapped in uint32
  rejection chain  sub_r = T(s_r, 1), s_{r+1} = T(s_r, 0), s_0 = the key

`Rng` counts the blocks it computes, so a caller that draws only what its
outputs need counts the least work of a step's draws.
"""

from __future__ import annotations

import numpy as np

MASK = 0xFFFFFFFF
_PARITY = np.uint32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> np.ndarray:
    """uint32[2]: the words of `jax.random.key(seed)`: (0, seed mod 2**32)
    for a seed in int32 range, else its high and low words (seed < 2**64)."""
    seed = int(seed)
    if -2**31 <= seed < 2**31:
        return np.array([0, seed & MASK], np.uint32)
    if 0 <= seed < 2**64:
        return np.array([seed >> 32, seed & MASK], np.uint32)
    raise ValueError(f"seed {seed} is neither in int32 range nor in "
                     "[0, 2**64)")


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def blocks(keys: np.ndarray, counters) -> np.ndarray:
    """uint32[..., 2]: T(key, j) of keys uint32[..., 2] and counters j,
    broadcast against the keys' leading axes."""
    with np.errstate(over="ignore"):
        k0 = keys[..., 0].astype(np.uint32)
        k1 = keys[..., 1].astype(np.uint32)
        k2 = k0 ^ k1 ^ _PARITY
        ks = (k0, k1, k2)
        x1 = np.asarray(counters, np.uint32)
        x0 = np.zeros(np.broadcast_shapes(k0.shape, x1.shape), np.uint32)
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return np.stack([x0, x1], -1)


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """float32 a * b + c rounded once: the product is exact in float64, the
    sum's error is found by TwoSum and folded into the last bit (round to
    odd), so the one rounding to float32 is correct."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(inexact, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(np.float32)


class Rng:
    """The draws, over lane keys uint32[L, 2]; `blocks` counts the
    threefry blocks computed."""

    def __init__(self):
        self.blocks = 0

    def block(self, keys, counters):
        out = blocks(keys, counters)
        self.blocks += out.size // 2
        return out

    def split(self, keys, n: int) -> np.ndarray:
        """uint32[L, n, 2]."""
        return self.block(keys[:, None, :], np.arange(n, dtype=np.uint32))

    def child(self, keys, j: int) -> np.ndarray:
        """uint32[L, 2]: split(keys, n)[:, j], one block a lane."""
        return self.block(keys, np.uint32(j))

    def bits(self, keys, n: int) -> np.ndarray:
        y = self.split(keys, n)
        return y[..., 0] ^ y[..., 1]

    def uniform(self, keys, n: int, lo=0.0, hi=1.0) -> np.ndarray:
        """float32[L, n] on [lo, hi)."""
        b = self.bits(keys, n)
        f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        f = f - np.float32(1.0)
        lo32 = np.float32(lo)
        span = np.float32(np.float32(hi) - lo32)
        return np.maximum(_fma_f32(f, span, lo32), lo32)

    def randint(self, keys, lo: int, hi: int) -> np.ndarray:
        """int32[L]: one `jax.random.randint(key, (), lo, hi)` a lane."""
        span = hi - lo if hi > lo else 1
        a = self.bits(self.child(keys, 0), 1)[:, 0].astype(np.uint64)
        b = self.bits(self.child(keys, 1), 1)[:, 0].astype(np.uint64)
        m = (1 << 16) % span
        m = ((m * m) & MASK) % span
        span64 = np.uint64(span)
        prod = ((a % span64) * np.uint64(m)) & np.uint64(MASK)
        offset = ((prod + b % span64) & np.uint64(MASK)) % span64
        out = (np.uint64(lo & MASK) + offset) & np.uint64(MASK)
        return out.astype(np.uint32).view(np.int32)
