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

Bulk draws (``uniform``, ``normal``: initial weights and device maps) use
threefry's random bits ``x0 ^ x1`` of ``threefry2x32(key, (0, i))`` at flat
index ``i``, vectorised in numpy ``uint32`` on the host, and the float
transforms of ``jax.random``.  XLA on the CPU contracts ``a * b + c`` into
one fused multiply-add, so those steps round once here too (in float64,
where the float32 product is exact, then to float32).  ``normal`` is
``sqrt(2) * erfinv(u)`` with XLA's float32 erfinv polynomial; its ``log1p``
is numpy's, so a draw agrees with ``jax.random.normal`` to 2 ulp.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

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


def _threefry_np(k: Key, x0: np.ndarray, x1: np.ndarray):
    """:func:`threefry2x32` over uint32 counter arrays (wrapping adds)."""
    k0, k1 = (np.uint32(v) for v in k)
    ks = (k0, k1, np.uint32(int(k0) ^ int(k1) ^ 0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r, rr in _ROT[i & 1]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(rr))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (uint32): ``x0 ^ x1`` of the block
    function at row-major flat index ``i`` (counter words ``(0, i)``)."""
    n = int(np.prod(shape)) if len(shape) else 1
    if n >= 1 << 32:
        raise ValueError("more than 2**32 random words")
    x0, x1 = _threefry_np(k, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return (x0 ^ x1).reshape(tuple(shape))


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as XLA's contracted FMA."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)``."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


# XLA's ErfInv32 (Giles' single-precision approximation), by w < 5 / w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(-(x * x)).astype(f32)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    coef = lambda i: np.where(small, f32(_ERFINV_SMALL[i]),  # noqa: E731
                              f32(_ERFINV_LARGE[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma32(p, w, coef(i))
    return (p * x).astype(f32)


def normal(k: Key, shape: Sequence[int], *, device="cpu") -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform in ``(-1, 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    z = np.float32(np.sqrt(2.0)) * _erfinv32(uniform(k, shape, lo, 1.0))
    return torch.from_numpy(np.ascontiguousarray(z, np.float32)).to(device)
