"""pulse_counts: the update cycle's coincidence counts of signed pulse
streams, ``count_up, count_dn = (|B|^T |A| +- B^T A) / 2``.

Replaces the TPU kernel ``pulse_counts_pallas`` (``src/repro/kernels/
pulse_update.py:112``, ``pallas_call`` at :136) with the CUDA kernel
``csrc/pulse_counts.cu``: 32 x 32 device tiles x 256 stream slots per block,
int32 counts from int8 copies of the streams in shared memory, summed into
the outputs with float atomics (exact integers below 2**24, so bitwise the
plain two-product version in any block order).  Bound: the bytes of the two
stream matrices; at LeNet's shapes, one launch.

:func:`pulse_counts` launches it for CUDA tensors and runs
:func:`pulse_counts_plain` only for CPU tensors.  ``launches`` counts kernel
launches.  (The TPU package's fused ``pulse_update_pallas`` — counts, maps,
ctoc and clip in one launch — has no caller on the training path and is not
ported yet.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.noisy_mvm import check_operands

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


def pulse_counts_plain(rows2: torch.Tensor, cols2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: two products over the slot axis (exact: the
    operands are 0, +-1 and every partial sum is an integer below 2**24)."""
    net = rows2.T @ cols2
    total = torch.abs(rows2).T @ torch.abs(cols2)
    return 0.5 * (total + net), 0.5 * (total - net)


def _lib():
    fn = build.load("pulse_counts").pulse_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pulse_counts(rows2: torch.Tensor, cols2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coincidence counts of row streams ``(T, M)`` and column streams
    ``(T, N)`` (float32, entries 0, +-1): ``(count_up, count_dn)``, each
    ``(M, N)`` float32."""
    global launches
    if rows2.dim() != 2 or cols2.dim() != 2 or rows2.shape[0] != \
            cols2.shape[0]:
        raise ValueError(f"streams {tuple(rows2.shape)} and "
                         f"{tuple(cols2.shape)} do not share a slot axis")
    if not rows2.is_cuda:
        return pulse_counts_plain(rows2, cols2)
    check_operands(rows2, cols2)
    t, m = rows2.shape
    n = cols2.shape[1]
    up = torch.empty(m, n, dtype=torch.float32, device=rows2.device)
    dn = torch.empty_like(up)
    rc = _lib()(rows2.data_ptr(), cols2.data_ptr(), up.data_ptr(),
                dn.data_ptr(), t, m, n,
                torch.cuda.current_stream(rows2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pulse_counts kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return up, dn
