"""noisy_mvm: the raw analog array read, ``y = sum_seg clip(W_seg x_seg +
sigma * xi, +-alpha)`` with a per-row saturation flag.

Replaces the TPU kernel ``noisy_mvm_pallas`` (``src/repro/kernels/
noisy_mvm.py:127``, ``pallas_call`` at :197) with the CUDA kernel
``csrc/noisy_mvm.cu``: one block per (row-block, out-block) walks the whole
contraction in a loop, adding counter-hash noise, the saturation flag and
the integrator clip at every contraction-segment boundary.  It is bound by
the bytes of W at decode batch sizes and by fp32 FMAs at prefill (see the
source's header note).

:func:`noisy_mvm` launches the kernel for CUDA tensors and runs
:func:`noisy_mvm_plain`, the same function in plain PyTorch, only for CPU
tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import fastrng

_M32 = 0xFFFFFFFF

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


def segments(k_dim: int, n_seg: int):
    """``(start, end)`` of each contraction segment (the last may be short)."""
    seg_len = -(-k_dim // n_seg)
    return [(si * seg_len, min(k_dim, (si + 1) * seg_len))
            for si in range(n_seg)]


def segment_product(w: torch.Tensor, x2d: torch.Tensor, k0: int, k1: int,
                    transpose: bool) -> torch.Tensor:
    """Raw product of one contraction segment, ``(B, out)``."""
    if transpose:
        return x2d[:, k0:k1] @ w[k0:k1, :]
    return x2d[:, k0:k1] @ w[:, k0:k1].T


def counters(rows: torch.Tensor, si: int, n_seg: int, out_dim: int
             ) -> torch.Tensor:
    """Flat u32 noise counters ``(row * n_seg + si) * out + col`` (int64)."""
    cols = torch.arange(out_dim, dtype=torch.int64, device=rows.device)
    base = ((rows * n_seg + si) & _M32) * out_dim
    return (base[:, None] + cols[None, :]) & _M32


def read_segment(v: torch.Tensor, seed_mixed: int, e: torch.Tensor,
                 n_total: int, sigma: float, alpha: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One physical read of a raw-product block: noise at counter ``e``,
    per-row saturation flag, integrator clip."""
    if sigma > 0.0:
        v = v + sigma * fastrng.normal_at(seed_mixed, e, n_total)
    if math.isfinite(alpha):
        sat = torch.any(torch.abs(v) >= alpha, dim=-1)
        v = torch.clamp(v, -alpha, alpha)
    else:
        sat = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    return v, sat


def noisy_mvm_plain(w: torch.Tensor, x2d: torch.Tensor, seed: int, *,
                    sigma: float, alpha: float, n_seg: int = 1,
                    transpose: bool = False, row_offset: Optional[int] = None,
                    total_rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same counters, same order)."""
    out_dim = w.shape[1] if transpose else w.shape[0]
    k_dim = x2d.shape[1]
    b = x2d.shape[0]
    total_rows = b if total_rows is None else total_rows
    n_total = (total_rows * n_seg * out_dim) & _M32
    seed_m = fastrng.mix_int(int(seed) & _M32)
    rows = (torch.arange(b, dtype=torch.int64, device=x2d.device)
            + (0 if row_offset is None else int(row_offset))) & _M32
    y = torch.zeros(b, out_dim, dtype=x2d.dtype, device=x2d.device)
    sat = torch.zeros(b, dtype=torch.bool, device=x2d.device)
    for si, (k0, k1) in enumerate(segments(k_dim, n_seg)):
        v = segment_product(w, x2d, k0, k1, transpose)
        e = counters(rows, si, n_seg, out_dim) if sigma > 0.0 else None
        v, s = read_segment(v, seed_m, e, n_total, sigma, alpha)
        sat = sat | s
        y = y + v
    return y, sat


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]


def _lib():
    lib = build.load("noisy_mvm")
    fn = lib.noisy_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_operands(w: torch.Tensor, *xs: torch.Tensor) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device."""
    for t in (w,) + xs:
        if not t.is_cuda or t.device != w.device:
            raise ValueError("kernel operands must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel operands are float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def noisy_mvm(w: torch.Tensor, x2d: torch.Tensor, seed: int, *,
              sigma: float, alpha: float, n_seg: int = 1,
              transpose: bool = False, row_offset: Optional[int] = None,
              total_rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw read of ``w`` (R, C) by ``x2d`` (B, C) — or (B, R) when
    ``transpose`` — with u32 ``seed``.  Returns ``y`` (B, out) and the
    per-row saturation flag (B,) bool."""
    global launches
    out_dim = w.shape[1] if transpose else w.shape[0]
    k_dim = w.shape[0] if transpose else w.shape[1]
    if x2d.dim() != 2 or x2d.shape[1] != k_dim:
        raise ValueError(f"x {tuple(x2d.shape)} does not match w "
                         f"{tuple(w.shape)} (transpose={transpose})")
    if not w.is_cuda:
        return noisy_mvm_plain(w, x2d, seed, sigma=sigma, alpha=alpha,
                               n_seg=n_seg, transpose=transpose,
                               row_offset=row_offset, total_rows=total_rows)
    check_operands(w, x2d)
    b = x2d.shape[0]
    total_rows = b if total_rows is None else total_rows
    y = torch.empty(b, out_dim, dtype=torch.float32, device=w.device)
    sat = torch.zeros(b, dtype=torch.int32, device=w.device)
    if b == 0:
        return y, sat.bool()
    seg_len = -(-k_dim // n_seg)
    rc = _lib()(
        w.data_ptr(), x2d.data_ptr(), y.data_ptr(), sat.data_ptr(),
        b, k_dim, out_dim, n_seg, seg_len, int(transpose),
        float(sigma), float(alpha), int(math.isfinite(alpha)),
        int(seed) & _M32, int(row_offset or 0) & _M32,
        (total_rows * n_seg * out_dim) & _M32,
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"noisy_mvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, sat != 0
