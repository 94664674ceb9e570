"""Host-side threefry2x32 PRNG keys, bit-compatible with ``jax.random``.

The analog read noise is drawn on the device from a counter hash seeded by
one u32 word per read (``fastrng.key_to_seed``); that word is derived from a
tree of ``split`` / ``fold_in`` calls over threefry keys.  This module is that
key schedule, run on the host in plain Python integers, so a read costs no
device round trip and the same key yields the same seed as in the JAX
package.

Mode: ``jax_threefry_partitionable=True`` (the default of jax 0.9), impl
``threefry2x32``:

* ``key(seed)``       -> ``(0, seed & 0xFFFFFFFF)`` (``key(7)`` = (0, 7))
* ``split(key, n)[i]`` = ``threefry2x32(key, (0, i))``
* ``fold_in(key, d)``  = ``threefry2x32(key, (0, d))``

A key is a tuple of two Python ints in ``[0, 2**32)``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
# (rotation, 32 - rotation) for the two alternating groups of four rounds
_ROT = tuple(tuple((r, 32 - r) for r in g)
             for g in ((13, 15, 26, 6), (17, 29, 16, 24)))


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The Threefry-2x32 block function (20 rounds) on one counter pair."""
    m = _M32
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & m
    x1 = (x1 + k1) & m
    for i in range(5):
        for r, rr in _ROT[i & 1]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) & m) | (x1 >> rr)) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for an int32 seed (jax's default, 32-bit
    mode: the high word is 0 and a negative seed wraps modulo 2**32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} is not an int32")
    return 0, seed & _M32


def split(k: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(k, n)`` as a list of ``n`` keys."""
    return [threefry2x32(k, 0, i) for i in range(n)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` (data taken modulo 2**32)."""
    return threefry2x32(k, 0, int(data) & _M32)


def key_data(k: Key) -> np.ndarray:
    """``jax.random.key_data(k)``: the two key words as uint32."""
    return np.asarray(k, dtype=np.uint32)


def from_key_data(data) -> Key:
    """Inverse of :func:`key_data` (accepts any length-2 integer array)."""
    a = np.asarray(data).astype(np.uint64).reshape(-1)
    if a.shape != (2,):
        raise ValueError(f"threefry key data has 2 words, got {a.shape}")
    return int(a[0]) & _M32, int(a[1]) & _M32
