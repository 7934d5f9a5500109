"""Threefry-2x32 draws bit-compatible with `jax.random`, for the seed
jitter of the tractography (`jax.random.uniform(PRNGKey(seed_rng),
(nsub, 3), -0.5 + 1e-6, 0.5 - 1e-6)`, reference: src/stream.jl jitter,
as the JAX package draws it).  Copied from the port's
`fibers_tpu_torch/utils/prng.py` (the generator of an input, not code
under test): the default `threefry2x32` in its partitionable layout,
where element i of the output takes the counter pair (hi, lo) of the
64-bit flat index i and keeps `bits1 ^ bits2`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prng_key", "uniform"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), on uint32 arrays.
    `key` is the pair (k0, k1); returns the two output words."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` with 64-bit mode off: the seed is an
    int32, so the high word is 0 and the low word its two's complement."""
    return (np.uint32(0), np.uint32(np.int64(seed) & 0xFFFFFFFF))


def _counter_words(n):
    """(hi, lo) uint32 words of the 64-bit flat indices 0..n-1."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def random_bits(key, shape):
    """32-bit random words of `shape` (partitionable counter layout)."""
    b0, b1 = threefry2x32(key, *_counter_words(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 uniform draw matching `jax.random.uniform` bit for bit:
    23 mantissa bits into [1, 2), minus 1, then the affine map
    `f * (maxval - minval) + minval` clamped below at minval.

    XLA contracts that map into one fused multiply-add, so it is rounded
    once here too: f (a multiple of 2^-23 in [0, 1)) times an f32 range
    is exact in float64, and for |minval|, |maxval| <= 1 so is the sum,
    which leaves the single rounding to float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    fma = f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))
