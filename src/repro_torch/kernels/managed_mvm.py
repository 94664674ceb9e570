"""managed_mvm: the fused managed analog read — NM scale, both two-phase BM
reads from one product, select-on-saturation, clip and the #_d replica
average.

Replaces the TPU kernel ``managed_mvm_pallas`` (``src/repro/kernels/
managed_mvm.py:187``, ``pallas_call`` at :284) with the CUDA kernel
``csrc/managed_mvm.cu``.  The TPU kernel holds a whole replica-padded output
row in VMEM so one per-row flag can gate the select; at out = 11008 or
102400 that does not fit Hopper's shared memory, so the CUDA read is two
launches: a main kernel over (row-block, out-block) that writes both reads'
partial sums and ORs the per-row flags with atomics, and a small epilogue
that selects, rescales and averages.  Bound: the bytes of W at decode, fp32
FMAs at prefill (see the source's header note).

:func:`managed_mvm` launches it for CUDA tensors and runs
:func:`managed_mvm_plain`, the same function in plain PyTorch, only for CPU
tensors.  ``launches`` counts managed reads (each is the two launches).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.noisy_mvm import (
    check_operands, counters, read_segment, segment_product, segments)
from repro_torch.utils import fastrng

_M32 = 0xFFFFFFFF

#: Managed reads launched since the last reset (``ops.reset_launch_counts``).
launches = 0


def select_and_average(acc1: torch.Tensor, acc2: Optional[torch.Tensor],
                       sat1: torch.Tensor, sat2: torch.Tensor,
                       s: torch.Tensor, *, two_phase: bool,
                       retry_scale: float, d_avg: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select-on-saturation, digital re-scale and #_d replica average — the
    managed read's epilogue.  ``s`` is ``(B, 1)``; returns (y, residual)."""
    if two_phase:
        y = torch.where(sat1[:, None], acc2 * retry_scale, acc1) * s
        residual = sat1 & sat2
    else:
        y = acc1 * s
        residual = sat1
    if d_avg > 1:
        out_f = y.shape[1] // d_avg
        acc = y[:, 0:out_f]
        for r in range(1, d_avg):
            acc = acc + y[:, r * out_f:(r + 1) * out_f]
        y = acc / float(d_avg)
    return y, residual


def managed_mvm_plain(w: torch.Tensor, x2d: torch.Tensor, nm_s: torch.Tensor,
                      seeds: Sequence[int], *, sigma: float, alpha: float,
                      n_seg: int = 1, transpose: bool = False,
                      two_phase: bool = False, retry_scale: float = 16.0,
                      d_avg: int = 1, row_offset: Optional[int] = None,
                      total_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same counters, same order)."""
    out_phys = w.shape[1] if transpose else w.shape[0]
    k_dim = x2d.shape[1]
    b = x2d.shape[0]
    total_rows = b if total_rows is None else total_rows
    n_total = (total_rows * n_seg * out_phys) & _M32
    seed1_m = fastrng.mix_int(int(seeds[0]) & _M32)
    seed2_m = fastrng.mix_int(int(seeds[1]) & _M32)
    rows = (torch.arange(b, dtype=torch.int64, device=x2d.device)
            + (0 if row_offset is None else int(row_offset))) & _M32
    s = nm_s.reshape(b, 1).to(torch.float32)
    zeros = lambda: torch.zeros(b, out_phys, dtype=torch.float32,
                                device=x2d.device)
    acc1, acc2 = zeros(), (zeros() if two_phase else None)
    sat1 = torch.zeros(b, dtype=torch.bool, device=x2d.device)
    sat2 = sat1.clone()
    for si, (k0, k1) in enumerate(segments(k_dim, n_seg)):
        v1 = segment_product(w, x2d, k0, k1, transpose) / s
        e = counters(rows, si, n_seg, out_phys) if sigma > 0.0 else None
        v, f = read_segment(v1, seed1_m, e, n_total, sigma, alpha)
        sat1 = sat1 | f
        acc1 = acc1 + v
        if two_phase:
            v, f = read_segment(v1 / retry_scale, seed2_m, e, n_total,
                                sigma, alpha)
            sat2 = sat2 | f
            acc2 = acc2 + v
    return select_and_average(acc1, acc2, sat1, sat2, s,
                              two_phase=two_phase, retry_scale=retry_scale,
                              d_avg=d_avg)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_void_p]


def _lib():
    lib = build.load("managed_mvm")
    fn = lib.managed_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def managed_mvm(w: torch.Tensor, x2d: torch.Tensor, nm_s: torch.Tensor,
                seeds: Sequence[int], *, sigma: float, alpha: float,
                n_seg: int = 1, transpose: bool = False,
                two_phase: bool = False, retry_scale: float = 16.0,
                d_avg: int = 1, row_offset: Optional[int] = None,
                total_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Managed read of ``w`` (d_avg * out_f, C) by ``x2d`` (B, C) — or
    (B, R) when ``transpose`` — with ``nm_s`` (B, 1) and the two u32 read
    seeds.  Returns ``y`` (B, out_f) and the residual flag (B,) bool."""
    global launches
    out_phys = w.shape[1] if transpose else w.shape[0]
    k_dim = w.shape[0] if transpose else w.shape[1]
    if transpose and d_avg != 1:
        raise ValueError("replica average is a forward-read operation")
    if out_phys % d_avg:
        raise ValueError(f"{out_phys} physical outputs, d_avg={d_avg}")
    if x2d.dim() != 2 or x2d.shape[1] != k_dim:
        raise ValueError(f"x {tuple(x2d.shape)} does not match w "
                         f"{tuple(w.shape)} (transpose={transpose})")
    if not w.is_cuda:
        return managed_mvm_plain(
            w, x2d, nm_s, seeds, sigma=sigma, alpha=alpha, n_seg=n_seg,
            transpose=transpose, two_phase=two_phase,
            retry_scale=retry_scale, d_avg=d_avg, row_offset=row_offset,
            total_rows=total_rows)
    b = x2d.shape[0]
    nm = nm_s.reshape(b)
    check_operands(w, x2d, nm)
    total_rows = b if total_rows is None else total_rows
    dev = w.device
    y = torch.empty(b, out_phys // d_avg, dtype=torch.float32, device=dev)
    residual = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return y, residual.bool()
    acc1 = torch.empty(b, out_phys, dtype=torch.float32, device=dev)
    acc2 = (torch.empty_like(acc1) if two_phase else acc1)
    flags = torch.zeros(2, b, dtype=torch.int32, device=dev)
    seg_len = -(-k_dim // n_seg)
    rc = _lib()(
        w.data_ptr(), x2d.data_ptr(), nm.data_ptr(), y.data_ptr(),
        residual.data_ptr(), acc1.data_ptr(), acc2.data_ptr(),
        flags[0].data_ptr(), flags[1].data_ptr(),
        b, k_dim, out_phys, d_avg, n_seg, seg_len, int(transpose),
        float(sigma), float(alpha), int(math.isfinite(alpha)),
        int(seeds[0]) & _M32, int(seeds[1]) & _M32, int(two_phase),
        float(retry_scale), int(row_offset or 0) & _M32,
        (total_rows * n_seg * out_phys) & _M32,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"managed_mvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, residual != 0
