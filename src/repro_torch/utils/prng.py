"""Threefry2x32 PRNG keys, bit-compatible with ``jax.random``.

The analog read noise is drawn on the device from a counter hash seeded by
one u32 word per read (``fastrng.key_to_seed``); that word is derived from a
tree of ``split`` / ``fold_in`` calls over threefry keys.  This module is that
key schedule, on two routes:

* a :data:`Key` is two Python ints: the tree runs on the host, and a seed
  reaches a kernel as a launch argument (the per-step loop, serving, the
  tests);
* a :class:`DeviceKey` is a slot of a :class:`KeyTape`: ``split`` and
  ``fold_in`` record the derivation, ``fastrng.key_to_seed`` returns a 0-d
  view of the tape's seed table, and the whole tree of a step is evaluated
  at once from a step counter in device memory, by the key-schedule kernel
  on the card (``kernels/key_schedule.py``) or its plain version on the
  CPU.  That is what lets one CUDA graph replay every step of an epoch
  (``train/engine.py``).

The same key yields the same seed as in the JAX package on both routes.

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

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
#: Key slots of a :class:`KeyTape`.  The key-schedule kernel holds a step's
#: keys in its 48 KB of shared memory, 8 bytes a key, up to 6144 slots, and
#: in the key table in device memory above that (an LM step whose SSD
#: projections read once per position records ~47k derivations).
TAPE_SLOTS = 1 << 16
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


class KeyTape:
    """The key tree of one step, recorded as derivations from a root.

    Slot 0 is the step's root key, ``fold_in(base, counter)`` with ``base``
    a key and ``counter`` an int64 scalar, both in device memory.  Op ``i``
    derives slot ``i + 1`` as ``threefry2x32(key[parent], (0, data))``:
    ``split(k, n)[j]`` and ``fold_in(k, j)`` are both that block.  A seed
    request appends an entry to the seed list and returns a 0-d view of
    :attr:`seeds`, which the evaluation fills.  A derivation or a seed asked
    for twice in one step is recorded once.

    A step function records its tree between :meth:`begin` and :meth:`end`;
    the first recording is kept, and every later one must equal it, so no
    key of the step depends on its data.  :meth:`program` is the recorded
    tape as the key-schedule kernel reads it.
    """

    def __init__(self, device="cpu"):
        dev = torch.device(device)
        self.keys = torch.zeros(TAPE_SLOTS, 2, dtype=torch.int64, device=dev)
        # one seed per slot at most: a slot's seed is recorded once
        self.seeds = torch.zeros(TAPE_SLOTS, dtype=torch.int64, device=dev)
        self.parent: List[int] = []
        self.data: List[int] = []
        self.seed_slots: List[int] = []
        self._slots: Dict[Tuple[int, int], int] = {}
        self._seed_index: Dict[int, int] = {}
        self._frozen: Optional[Tuple[tuple, tuple, tuple]] = None
        self._program = None

    def begin(self) -> "DeviceKey":
        """Start recording a step; returns its root key (slot 0)."""
        self.parent, self.data, self.seed_slots = [], [], []
        self._slots, self._seed_index = {}, {}
        return DeviceKey(self, 0)

    def end(self) -> None:
        """Finish a step's recording: keep the first, check every later one
        against it."""
        rec = (tuple(self.parent), tuple(self.data), tuple(self.seed_slots))
        if self._frozen is None:
            self._frozen = rec
        elif rec != self._frozen:
            raise RuntimeError(
                f"the step's key tree changed: {len(rec[0])} derivations and "
                f"{len(rec[2])} seeds against {len(self._frozen[0])} and "
                f"{len(self._frozen[2])} when it was first recorded (a key "
                "that depends on the step's data cannot be scheduled ahead)")

    def derive(self, slot: int, data: int) -> int:
        """The slot of ``threefry2x32(key[slot], (0, data))``."""
        op = (slot, int(data) & _M32)
        new = self._slots.get(op)
        if new is None:
            if len(self.parent) + 1 >= TAPE_SLOTS:
                raise RuntimeError(f"key tape full ({TAPE_SLOTS} slots)")
            self.parent.append(op[0])
            self.data.append(op[1])
            new = self._slots[op] = len(self.parent)
        return new

    def seed(self, slot: int) -> torch.Tensor:
        """The seed word of ``slot``: a 0-d int64 view of the seed table."""
        j = self._seed_index.get(slot)
        if j is None:
            self.seed_slots.append(slot)
            j = self._seed_index[slot] = len(self.seed_slots) - 1
        return self.seeds[j]

    @property
    def recorded(self) -> Tuple[tuple, tuple, tuple]:
        """The first recording: ``(parent, data, seed_slots)``."""
        if self._frozen is None:
            raise RuntimeError("no step has been recorded on this tape")
        return self._frozen

    def program(self):
        """The recorded tape on the tables' device, made once: ``(parent,
        data, level, seed_slot)`` int32 tensors (data as u32 bits) and the
        number of levels."""
        if self._program is None:
            parent, data, slots = self.recorded
            level = []
            for p in parent:
                level.append(level[p - 1] + 1 if p else 1)
            dev = self.seeds.device
            as_i32 = lambda v, dt=np.int32: torch.from_numpy(  # noqa: E731
                np.asarray(v, dtype=dt).view(np.int32).reshape(-1)).to(dev)
            self._program = (as_i32(parent), as_i32(data, np.uint32),
                             as_i32(level), as_i32(slots),
                             max(level, default=0))
        return self._program


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceKey:
    """A key of a :class:`KeyTape`: ``split``/``fold_in`` record on the tape
    and ``fastrng.key_to_seed`` returns a view of its seed table."""
    tape: KeyTape
    slot: int

    def derive(self, data: int) -> "DeviceKey":
        return DeviceKey(self.tape, self.tape.derive(self.slot, data))


AnyKey = Union[Key, DeviceKey]


def split(k: AnyKey, n: int = 2) -> List[AnyKey]:
    """``jax.random.split(k, n)`` as a list of ``n`` keys."""
    if isinstance(k, DeviceKey):
        return [k.derive(i) for i in range(n)]
    return [threefry2x32(k, 0, i) for i in range(n)]


def fold_in(k: AnyKey, data: int) -> AnyKey:
    """``jax.random.fold_in(k, data)`` (data taken modulo 2**32)."""
    if isinstance(k, DeviceKey):
        return k.derive(data)
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


class KeyStack:
    """A stack of host keys, ``data`` ``(n, 2)`` uint32: the port's form
    of a JAX key array with a leading layer axis (the stacked tiles' seeds
    of an LM checkpoint)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data, dtype=np.uint32).reshape(-1, 2)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data.shape[0],)

    def __getitem__(self, i: int) -> Key:
        return from_key_data(self.data[i])

    def __len__(self) -> int:
        return self.data.shape[0]

    @classmethod
    def of(cls, keys: Sequence[Key]) -> "KeyStack":
        return cls(np.asarray(keys, dtype=np.uint32))


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
    uniform in ``(-1, 1)``.  Drawn on the host for a CPU tensor, and by
    torch operations on a card (:func:`normal_on_device`: the same
    threefry bits and uniforms; both erfinvs within 3 ulp of
    ``jax.random.normal``'s)."""
    if torch.device(device).type != "cpu":
        return normal_on_device(k, shape, device=device)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    z = np.float32(np.sqrt(2.0)) * _erfinv32(uniform(k, shape, lo, 1.0))
    return torch.from_numpy(np.ascontiguousarray(z, np.float32)).to(device)


#: Entries of one chunk of :func:`normal_on_device`: its int64 threefry
#: words take 512 MB each.
NORMAL_CHUNK = 1 << 26


def _threefry_bits_t(k: Key, idx: torch.Tensor) -> torch.Tensor:
    """``x0 ^ x1`` of :func:`threefry2x32` at counters ``(0, idx)``, on
    int64 tensors holding u32 words (in place on ``idx``'s copy)."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = torch.full_like(idx, k0)
    x1 = idx.add(k1).bitwise_and_(_M32)
    for i in range(5):
        for r, rr in _ROT[i & 1]:
            x0.add_(x1).bitwise_and_(_M32)
            t = torch.bitwise_left_shift(x1, r).bitwise_and_(_M32)
            x1.bitwise_right_shift_(rr).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0.bitwise_xor_(x1)


def _fma32_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (in float64, as
    :func:`_fma32`)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def normal_on_device(k: Key, shape: Sequence[int], *,
                     device) -> torch.Tensor:
    """:func:`normal` by torch operations on ``device``, in chunks of
    :data:`NORMAL_CHUNK` entries: the threefry words in int64, the
    uniform's fused multiply-add and the erfinv polynomial's in float64
    rounded once to float32, its ``log1p`` in float64 and rounded (numpy's
    and XLA's float32 ``log1p`` each round some entries another way)."""
    f32 = np.float32
    n = int(np.prod(shape)) if len(shape) else 1
    if n >= 1 << 32:
        raise ValueError("more than 2**32 random words")
    lo = f32(np.nextafter(f32(-1.0), f32(0.0)))
    span = float(f32(1.0) - lo)
    sqrt2 = float(f32(np.sqrt(2.0)))
    small_c = [float(f32(v)) for v in _ERFINV_SMALL]
    large_c = [float(f32(v)) for v in _ERFINV_LARGE]
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, NORMAL_CHUNK):
        idx = torch.arange(s, min(n, s + NORMAL_CHUNK), dtype=torch.int64,
                           device=device)
        bits = _threefry_bits_t(k, idx)
        fl = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(
            torch.int32).view(torch.float32) - 1.0
        x = torch.clamp_min(_fma32_t(fl, span, float(lo)), float(lo))
        del bits, fl
        w = -torch.log1p((-(x * x)).to(torch.float64)).to(torch.float32)
        small = w < 5.0
        w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(small, small_c[0], large_c[0])
        for a, b in zip(small_c[1:], large_c[1:]):
            p = _fma32_t(p, w.to(torch.float64),
                         torch.where(small, a, b).to(torch.float64))
        out[s:s + x.numel()] = sqrt2 * (p * x)
    return out.reshape(tuple(shape))


def truncated_normal(k: Key, lower: float, upper: float,
                     shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32: ``sqrt(2) * erfinv(u)``
    with ``u`` uniform between ``erf(lower / sqrt(2))`` and ``erf(upper /
    sqrt(2))``, clipped into the open interval ``(lower, upper)``."""
    f32 = np.float32
    sqrt2 = f32(np.sqrt(2.0))
    a, b = (f32(math.erf(float(f32(v) / sqrt2))) for v in (lower, upper))
    z = (sqrt2 * _erfinv32(uniform(k, shape, a, b))).astype(f32)
    return np.clip(z, np.nextafter(f32(lower), f32(np.inf)),
                   np.nextafter(f32(upper), f32(-np.inf)))
