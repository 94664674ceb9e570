"""Counter-hash RNG (splitmix32 finalizer + Box-Muller), bit-compatible with
the JAX package's ``utils/fastrng.py`` and with the read kernels' on-device
noise.

Torch has no full uint32 arithmetic on the CPU, so the u32 words live in
int64 tensors masked to 32 bits.  Both multipliers are below 2**31, so a
masked 32-bit word times a multiplier stays below 2**63 and never
overflows before the mask.

``key_to_seed`` collapses a threefry key (``utils/prng.py``) to the single
u32 seed word a read consumes: on the host for a :data:`prng.Key`, and as a
view of the key tape's seed table for a :class:`prng.DeviceKey` (the table
is filled on the card by the key-schedule kernel, on the CPU by its plain
version).  Every function here that takes a seed word takes either form: a
Python int, or a 0-d int64 tensor on the data's device, so a captured CUDA
graph reads the seed from device memory instead of baking it in.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.utils.prng import AnyKey, DeviceKey

#: A u32 seed word: a Python int, or a 0-d int64 tensor holding one.
Seed = Union[int, torch.Tensor]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x21F0AAAD
_M2 = 0x735A2D97
_INV24 = 1.0 / (1 << 24)
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def mix_int(x: int) -> int:
    """splitmix32 finalizer on one host-side u32 word."""
    x = (x + _GOLDEN) & _M32
    x = ((x ^ (x >> 16)) * _M1) & _M32
    x = ((x ^ (x >> 15)) * _M2) & _M32
    return x ^ (x >> 15)


def mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on an int64 tensor of u32 words."""
    x = (x + _GOLDEN) & _M32
    x = ((x ^ (x >> 16)) * _M1) & _M32
    x = ((x ^ (x >> 15)) * _M2) & _M32
    return x ^ (x >> 15)


def mix_seed(seed: Seed) -> Seed:
    """:func:`mix` of a u32 seed word; a tensor seed stays on its device."""
    if isinstance(seed, torch.Tensor):
        return mix(seed & _M32)
    return mix_int(int(seed) & _M32)


def key_to_seed(key: AnyKey) -> Seed:
    """Collapse a threefry key to a single u32 seed word (a 0-d view of the
    tape's seed table for a device key)."""
    if isinstance(key, DeviceKey):
        return key.tape.seed(key.slot)
    seed = 0
    for word in key:
        seed = mix_int(seed ^ (int(word) & _M32))
    return seed


def uniform24(b: torch.Tensor) -> torch.Tensor:
    """u32 words -> U[0, 1) float32 with 24-bit resolution."""
    return (b >> 8).to(torch.float32) * _INV24


def normal_at(seed_mixed: Seed, e: torch.Tensor, n_total: int
              ) -> torch.Tensor:
    """Standard normal at flat u32 counters ``e`` (int64 tensor): u1 from
    counter ``e``, u2 from ``e + n_total`` — the read kernels' layout."""
    u1 = torch.clamp_min(uniform24(mix(e ^ seed_mixed)), 1e-7)
    u2 = uniform24(mix(((e + (n_total & _M32)) & _M32) ^ seed_mixed))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)


def _offset_counter(shape: Sequence[int], offset: Optional[int],
                    device) -> torch.Tensor:
    n = int(np.prod(shape)) if len(shape) else 1
    e = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    if offset is not None:
        e = (e + (int(offset) & _M32)) & _M32
    return e & _M32


def bits_from_seed(seed: Seed, shape: Sequence[int],
                   offset: Optional[int] = None, *, device="cpu"
                   ) -> torch.Tensor:
    """u32 random words (int64 tensor) of the u32 ``seed`` word at the
    row-major counters of ``shape`` shifted by ``offset``."""
    return mix(_offset_counter(shape, offset, device) ^ mix_seed(seed))


def bits(key: AnyKey, shape: Sequence[int], offset: Optional[int] = None, *,
         device="cpu") -> torch.Tensor:
    """u32 random words (int64 tensor) at the row-major counters of
    ``shape`` shifted by ``offset``."""
    return bits_from_seed(key_to_seed(key), shape, offset, device=device)


def uniform(key: AnyKey, shape: Sequence[int], dtype=torch.float32, *,
            offset: Optional[int] = None, device="cpu") -> torch.Tensor:
    """U[0, 1) with 24-bit resolution; ``offset`` shifts the flat counter so
    a chunked draw equals the matching row slice of the full draw."""
    return uniform24(bits(key, shape, offset, device=device)).to(dtype)


def normal(key: AnyKey, shape: Sequence[int], dtype=torch.float32, *,
           offset: Optional[int] = None, total: Optional[int] = None,
           device="cpu") -> torch.Tensor:
    """Standard normal via Box-Muller over two counter streams (u1 at e, u2
    at ``total + e``); ``offset``/``total`` give chunked draws that equal
    row slices of the full draw."""
    n = total if total is not None else (
        int(np.prod(shape)) if len(shape) else 1)
    seed_m = mix_seed(key_to_seed(key))
    z = normal_at(seed_m, _offset_counter(shape, offset, device), n)
    return z.to(dtype)
