"""The JAX package's default PRNG in numpy: threefry-2x32 with JAX's key
derivation, so that the port's synthetic batches are bitwise those of
``repro.data``.

Mirrors ``jax._src.prng`` and ``jax._src.random`` as jax 0.9.0 runs them by
default (``jax_threefry_partitionable`` True): a key is two uint32 words;
``fold_in(key, d)`` hashes the pair (0, d); ``split`` and ``random_bits``
hash the 64-bit flat index of each output as (high word, low word), and
32-bit random bits are the xor of the hash's two words; ``randint`` draws
two words a value from the two keys of a split and folds them into the
span as JAX does, all in wrapping uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(v, r):
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the word pairs (x0, x1) under
    ``key`` (two uint32 words); uint32 arrays of x0's shape."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, dtype=_U32) + ks[0]
    x1 = np.asarray(x1, dtype=_U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    return np.array([0, seed & 0xFFFFFFFF], dtype=_U32)


def fold_in(key, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(1, _U32), np.array([data & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], dtype=_U32)


def _counts(shape):
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32).reshape(shape),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape))


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) keys."""
    a, b = threefry2x32(key, *_counts((num,)))
    return np.stack([a, b], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """uint32 bits of ``shape``."""
    a, b = threefry2x32(key, *_counts(tuple(shape)))
    return a ^ b


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 values in [minval, maxval), as ``jax.random.randint(key, shape,
    minval, maxval, jnp.int32)`` draws them for bounds within int32."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval) if maxval > minval else _U32(1)
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + (lower % span)) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)
