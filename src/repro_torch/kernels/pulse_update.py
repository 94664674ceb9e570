"""The update cycle's kernels on signed pulse streams: the coincidence
counts ``count_up, count_dn = (|B|^T |A| +- B^T A) / 2`` alone, and the
fused update (counts, device maps, cycle-to-cycle noise, bound clip).

Replaces the TPU kernel ``pulse_counts_pallas`` (``src/repro/kernels/
pulse_update.py:112``, ``pallas_call`` at :136) with the CUDA kernel
``csrc/pulse_counts.cu``: 32 x 32 device tiles x 256 stream slots per block,
int32 counts from int8 copies of the streams in shared memory, summed into
the outputs with float atomics (exact integers below 2**24, so bitwise the
plain two-product version in any block order).  Bound: the bytes of the two
stream matrices; at LeNet's shapes, one launch.

:func:`pulse_counts` launches it for CUDA tensors and runs
:func:`pulse_counts_plain` only for CPU tensors; given ``out`` it adds the
counts to those tensors instead of zeroing them first (a streaming update's
later chunks, ``core/update.py``).  ``launches`` counts kernel launches.

:func:`pulse_update` replaces the fused TPU kernel ``pulse_update_pallas``
(``pulse_update.py:166``, ``pallas_call`` at :191) with
``csrc/pulse_update.cu``: one block per 32 x 32 device tile walks the whole
T (no atomics), then applies ``dw = up dw_up - dn dw_dn + ctoc sqrt(up
dw_up^2 + dn dw_dn^2) xi`` (``xi`` the counter-hash normal at ``row * N +
col``) and the clip to +-bound in the block.  Bound: the bytes of the
streams and the five (M, N) tiles.  It launches for CUDA tensors, runs
:func:`pulse_update_plain` only for CPU tensors, and counts its launches in
``update_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.noisy_mvm import check_operands

#: Kernel launches since the last reset (``ops.reset_launch_counts``):
#: pulse counts, fused updates.
launches = 0
update_launches = 0


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pulse_counts(rows2: torch.Tensor, cols2: torch.Tensor,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coincidence counts of row streams ``(T, M)`` and column streams
    ``(T, N)`` (float32, entries 0, +-1): ``(count_up, count_dn)``, each
    ``(M, N)`` float32; with ``out``, those two tensors with the counts
    added to them (exact: integers below 2**24)."""
    global launches
    if rows2.dim() != 2 or cols2.dim() != 2 or rows2.shape[0] != \
            cols2.shape[0]:
        raise ValueError(f"streams {tuple(rows2.shape)} and "
                         f"{tuple(cols2.shape)} do not share a slot axis")
    t, m = rows2.shape
    n = cols2.shape[1]
    if out is not None and any(o.shape != (m, n) for o in out):
        raise ValueError(f"counts {[tuple(o.shape) for o in out]} do not "
                         f"fit streams of {m} and {n} drivers")
    if not rows2.is_cuda:
        up, dn = pulse_counts_plain(rows2, cols2)
        if out is None:
            return up, dn
        return out[0].add_(up), out[1].add_(dn)
    check_operands(rows2, cols2, *(out or ()))
    if out is None:
        up = torch.empty(m, n, dtype=torch.float32, device=rows2.device)
        dn = torch.empty_like(up)
    else:
        up, dn = out
    rc = _lib()(rows2.data_ptr(), cols2.data_ptr(), up.data_ptr(),
                dn.data_ptr(), t, m, n, int(out is not None),
                torch.cuda.current_stream(rows2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pulse_counts kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return up, dn


def pulse_update_plain(w: torch.Tensor, dw_up: torch.Tensor,
                       dw_dn: torch.Tensor, bound: torch.Tensor,
                       rows2: torch.Tensor, cols2: torch.Tensor, seed: int,
                       ctoc: float) -> torch.Tensor:
    """Plain PyTorch version of the fused update, in the kernel's order of
    operations: counts, then the update cycle's own finalize
    (``update.counts_to_dw``: maps, ctoc noise at ``row * N + col``), clip."""
    from repro_torch.core import update
    up, dn = pulse_counts_plain(rows2, cols2)
    dw = update.counts_to_dw(up, dn, dw_up, dw_dn, seed, ctoc)
    return torch.clamp(w + dw, -bound, bound)


def _update_lib():
    fn = build.load("pulse_update").pulse_update_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pulse_update(w: torch.Tensor, dw_up: torch.Tensor, dw_dn: torch.Tensor,
                 bound: torch.Tensor, rows2: torch.Tensor,
                 cols2: torch.Tensor, seed: int, *, ctoc: float
                 ) -> torch.Tensor:
    """One update cycle of the physical weights ``w (M, N)`` under the
    device maps ``dw_up``, ``dw_dn``, ``bound`` (each ``(M, N)``) from row
    streams ``(T, M)`` and column streams ``(T, N)`` (entries 0, +-1), with
    ctoc noise from the u32 ``seed``.  Returns the new weights."""
    global update_launches
    m, n = w.shape
    if rows2.dim() != 2 or cols2.dim() != 2 or rows2.shape[0] != \
            cols2.shape[0] or rows2.shape[1] != m or cols2.shape[1] != n:
        raise ValueError(f"streams {tuple(rows2.shape)} and "
                         f"{tuple(cols2.shape)} do not fit weights "
                         f"{tuple(w.shape)}")
    for t in (dw_up, dw_dn, bound):
        if t.shape != w.shape:
            raise ValueError(f"map {tuple(t.shape)} does not fit weights "
                             f"{tuple(w.shape)}")
    if not w.is_cuda:
        return pulse_update_plain(w, dw_up, dw_dn, bound, rows2, cols2,
                                  seed, ctoc)
    check_operands(w, dw_up, dw_dn, bound, rows2, cols2)
    out = torch.empty_like(w)
    rc = _update_lib()(w.data_ptr(), dw_up.data_ptr(), dw_dn.data_ptr(),
                       bound.data_ptr(), rows2.data_ptr(), cols2.data_ptr(),
                       out.data_ptr(), rows2.shape[0], m, n,
                       int(seed) & 0xFFFFFFFF, float(ctoc),
                       torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pulse_update kernel launch failed: CUDA error "
                           f"{rc}")
    update_launches += 1
    return out
