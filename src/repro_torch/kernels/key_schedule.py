"""key_schedule: every key and seed of one step, evaluated from a step
counter in device memory.

Not the port of a TPU kernel: the counterpart of the threefry that XLA runs
inside the JAX package's jitted epoch (``src/repro/train/engine.py``,
``fold_in_keys`` at :53), which derives each step's keys inside the scan.
A CUDA graph fixes the arguments of its kernels when it is captured, so a
replayed step cannot take its seeds by value: the kernels read them from
the seed table of a :class:`~repro_torch.utils.prng.KeyTape`, and
``csrc/key_schedule.cu`` fills that table in one launch at the start of
each step.  Its root is ``fold_in(base, counter)``; the recorded tape
derives every other key from it, level by level.

:func:`key_schedule` launches the kernel for a tape on a CUDA device and
runs :func:`key_schedule_plain`, the same evaluation in Python ints
(``prng.threefry2x32``), only for a tape on the CPU.  ``launches`` counts
kernel launches: the wrapper's, and a captured graph's replays through
``ops.add_launch_counts``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import fastrng, prng

_M32 = 0xFFFFFFFF

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


def evaluate_plain(tape: prng.KeyTape, base: prng.Key, counter: int
                   ) -> Tuple[list, list]:
    """Every key of the recorded tape under the root ``fold_in(base,
    counter)`` and every seed, as Python ints: ``(keys, seeds)``."""
    parent, data, slots = tape.recorded
    keys = [prng.fold_in(base, counter)]
    for p, d in zip(parent, data):  # tape order: a parent precedes its ops
        keys.append(prng.threefry2x32(keys[p], 0, d))
    return keys, [fastrng.key_to_seed(keys[s]) for s in slots]


def key_schedule_plain(tape: prng.KeyTape, base: torch.Tensor,
                       counter: torch.Tensor) -> None:
    """Plain version: fill the tape's tables from ``base`` (2,) and
    ``counter`` (0-d), int64 tensors on the CPU."""
    k0, k1 = (int(v) & _M32 for v in base.tolist())
    keys, seeds = evaluate_plain(tape, (k0, k1), int(counter))
    tape.keys[:len(keys)] = torch.tensor(keys, dtype=torch.int64)
    tape.seeds[:len(seeds)] = torch.tensor(seeds, dtype=torch.int64)


def _lib():
    fn = build.load("key_schedule").key_schedule_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def key_schedule(tape: prng.KeyTape, base: torch.Tensor,
                 counter: torch.Tensor) -> None:
    """Fill ``tape.keys`` and ``tape.seeds`` for the step whose root key is
    ``fold_in(base, counter)``: ``base`` the two words of a key and
    ``counter`` the step counter, int64 tensors on the tape's device (read
    when the kernel runs, so a captured launch follows them)."""
    global launches
    dev = tape.seeds.device
    for t in (base, counter):
        if t.dtype != torch.int64 or t.device != dev:
            raise ValueError(f"base and counter are int64 on {dev}")
    if base.shape != (2,) or counter.numel() != 1:
        raise ValueError("base is (2,) and counter one word")
    if dev.type != "cuda":
        key_schedule_plain(tape, base, counter)
        return
    parent, data, level, slots, n_levels = tape.program()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(base.data_ptr(), counter.data_ptr(), parent.data_ptr(),
                data.data_ptr(), level.data_ptr(), parent.numel(), n_levels,
                slots.data_ptr(), slots.numel(), tape.keys.data_ptr(),
                tape.seeds.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"key_schedule kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
