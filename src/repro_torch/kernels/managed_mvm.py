"""managed_mvm: the fused managed analog read — NM scale, both two-phase BM
reads from one product, select-on-saturation, clip and the #_d replica
average.

Replaces the TPU kernel ``managed_mvm_pallas`` (``src/repro/kernels/
managed_mvm.py:187``, ``pallas_call`` at :284) with the CUDA kernel
``csrc/managed_mvm.cu`` (product and epilogue in ``csrc/managed_gemm.cuh``).
The TPU kernel holds a whole replica-padded output row in VMEM so one
per-row flag can gate the select; here the flags are ORed across blocks
into a scratch per device and stream that every call leaves zeroed, and
:func:`plan` picks one of two paths from the shapes:

* decode (forward, B <= 8): one cooperative launch.  A gemv streams W with
  float4 loads (x through L1), meets at a grid-wide barrier once every flag
  is raised, selects, and its last block clears the flags.  Bound: the
  bytes of W.
* everything else (prefill, transpose): a SIMT SGEMM with 8x8 outputs per
  thread in 128x128 or 64x128 tiles (chosen so the grid fills the card), a
  block per tile and contraction segment, then an epilogue launch that adds
  the segments in order.  Bound: fp32 FMAs (IEEE, no TF32).

:func:`managed_mvm` launches it for CUDA tensors and runs
:func:`managed_mvm_plain`, the same function in plain PyTorch, only for CPU
tensors.  ``launches`` counts managed reads (one or two launches each).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm import (  # noqa: F401 (the plan's constants)
    GEMV_MAXB, SMS, TILES, scratch, seed_arg, tile_shape, vec_rows)
from repro_torch.kernels.noisy_mvm import (
    check_operands, chunk_layout, counters, read_segment, segment_product,
    segments)
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
                      seeds: Sequence[fastrng.Seed], *, sigma: float,
                      alpha: float, n_seg: int = 1, transpose: bool = False,
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
    seed1_m = fastrng.mix_seed(seeds[0])
    seed2_m = fastrng.mix_seed(seeds[1])
    rows = (torch.arange(b, dtype=torch.int64, device=x2d.device)
            + (0 if row_offset is None else int(row_offset))) & _M32
    s = nm_s.reshape(b, 1).to(torch.float32)
    zeros = lambda: torch.zeros(b, out_phys, dtype=torch.float32,
                                device=x2d.device)
    acc1, acc2 = zeros(), (zeros() if two_phase else None)
    sat1 = torch.zeros(b, dtype=torch.bool, device=x2d.device)
    sat2 = sat1.clone()
    xl, keep = chunk_layout(x2d, row_offset, total_rows)
    for si, (k0, k1) in enumerate(segments(k_dim, n_seg)):
        v1 = segment_product(w, xl, k0, k1, transpose)[keep] / s
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


class Plan(NamedTuple):
    """How the kernel runs one read: ``path`` "gemv" (one launch) or
    "tile" (tile_m x tile_n tiles, then the epilogue launch); ``ncw``
    outputs per warp of the gemv; ``vec``: 16-byte loads (every row
    16-byte aligned), else aligned scalar loads."""
    path: str
    tile_m: int
    tile_n: int
    ncw: int
    vec: bool


def plan(b: int, k_dim: int, out_phys: int, transpose: bool,
         aligned: bool = True, n_seg: int = 1) -> Plan:
    """The kernel's path for a read of ``b`` rows, contraction ``k_dim`` in
    ``n_seg`` segments and ``out_phys`` outputs; ``aligned``: both base
    pointers 16-byte aligned.  Rows are 16-byte aligned when every row
    length is a multiple of 4 floats (x and W share k_dim; W's rows are
    out_phys long when transposed).  The gemv takes 2 outputs per warp,
    or 1 below 4096 outputs (where 2 would leave fewer than two 16-output
    blocks per SM).  The tiled path runs a block per tile and segment,
    and takes 128x128 tiles where they give every SM a block, else 64x128
    (8x8 outputs per thread leave few threads at small batch).  A chunk of
    a larger read is planned at the whole read's ``b`` (its
    ``total_rows``), so its rows take the whole read's path and add their
    products in its order."""
    vec = vec_rows(aligned, k_dim, out_phys, transpose)
    if not transpose and b <= GEMV_MAXB:
        ncw = 2 if out_phys >= 4096 else 1
        return Plan("gemv", 0, 0, ncw, vec)
    return Plan("tile", *tile_shape(b, out_phys, n_seg), 0, vec)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
    ctypes.c_uint32] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3

def _lib():
    lib = build.load("managed_mvm")
    fn = lib.managed_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def managed_mvm(w: torch.Tensor, x2d: torch.Tensor, nm_s: torch.Tensor,
                seeds: Sequence[fastrng.Seed], *, sigma: float, alpha: float,
                n_seg: int = 1, transpose: bool = False,
                two_phase: bool = False, retry_scale: float = 16.0,
                d_avg: int = 1, row_offset: Optional[int] = None,
                total_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Managed read of ``w`` (d_avg * out_f, C) by ``x2d`` (B, C) — or
    (B, R) when ``transpose`` — with ``nm_s`` (B, 1) and the two u32 read
    seeds (ints, or 0-d int64 tensors on the device that the kernel reads
    when it runs).  Returns ``y`` (B, out_f) and the residual flag (B,)
    bool."""
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
    residual = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return y, residual
    # planned as the whole read that this one may be a chunk of: every
    # row then sums its products in the whole read's order
    p = plan(max(b, total_rows), k_dim, out_phys, transpose,
             w.data_ptr() % 16 == 0 and x2d.data_ptr() % 16 == 0, n_seg)
    n_acc = b * out_phys
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags, part = scratch(dev, stream, 4 + 2 * b,
                          2 * n_acc if p.path == "gemv" else 0)
    if p.path == "gemv":
        acc1, acc2 = part, part[n_acc:]
    else:
        # one plane per contraction segment, added in order at the end
        acc1 = torch.empty(n_seg, b, out_phys, dtype=torch.float32,
                           device=dev)
        acc2 = torch.empty_like(acc1) if two_phase else acc1
    (s1, s1_at), (s2, s2_at) = (seed_arg(s, dev) for s in seeds[:2])
    rc = _lib()(
        w.data_ptr(), x2d.data_ptr(), nm.data_ptr(), y.data_ptr(),
        residual.data_ptr(), acc1.data_ptr(), acc2.data_ptr(),
        flags.data_ptr(), (flags.numel() - 4) // 2,
        b, k_dim, out_phys, d_avg, n_seg, -(-k_dim // n_seg), int(transpose),
        float(sigma), float(alpha), int(math.isfinite(alpha)),
        s1, s2, int(two_phase), float(retry_scale),
        int(row_offset or 0) & _M32, (total_rows * n_seg * out_phys) & _M32,
        int(p.path == "tile"), p.tile_m, p.tile_n, p.ncw, int(p.vec), s1_at,
        s2_at, stream)
    if rc != 0:
        raise RuntimeError(f"managed_mvm kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y, residual
