"""bwd_update_mvm: the backward and update cycles of one analog layer in one
kernel launch — the managed transpose read of the replicated errors AND the
update's integer coincidence counts, with the pulse streams regenerated in
the kernel and never stored.

Replaces the TPU kernels ``bwd_update_mvm_pallas`` (``src/repro/kernels/
bwd_update_mvm.py:222``, ``pallas_call`` at :276; dense layers) and
``conv_bwd_update_pallas`` (:473, ``pallas_call`` at :526; conv layers,
column drivers assembled from the activation volume) with the two entries
of ``csrc/bwd_update_mvm.cu``: one grid of read blocks (the tiled transpose
read) and count blocks (device tiles x stream slots, counts added with
atomics, exact), then the read's select/average epilogue.  The caller
finishes the cycle with ``update.finalize_counts``.

Stream counters (the separate path's, ``update.signed_streams``): A at
``((row0 + row) * BL + slot) * n_cols + col`` under ``k_a``, B at
``((row0 + row) * BL + slot) * m_phys + i`` under ``k_b``, driven by the
negated errors; a conv layer's column index is channel-major, so its counts
come out in the parameter matrix's layout.

:func:`bwd_update_mvm` / :func:`conv_bwd_update` launch the kernel for CUDA
tensors and run the plain versions (the managed transpose read and the
two-product counts of the digitally sampled streams) only for CPU tensors.
``launches`` / ``conv_launches`` count the two entries.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.core import management
from repro_torch.core import update as update_lib
from repro_torch.core.conv_mapping import gather_columns
from repro_torch.kernels import build
from repro_torch.kernels.conv_mvm import geom_array
from repro_torch.kernels.managed_mvm import managed_mvm_plain
from repro_torch.kernels.noisy_mvm import check_operands

_M32 = 0xFFFFFFFF

#: Fused launches since the last reset (``ops.reset_launch_counts``).
launches = 0
conv_launches = 0


def bwd_update_eligible(cfg, w_shape: Tuple[int, int]) -> bool:
    """True when the fused kernel takes a dense or conv layer's backward
    pass: fusion requested, kernels on, counter-hash RNG, fixed-latency BM,
    no tile grid and one transpose-read segment.  The TPU kernels also gate
    on 8 MB of VMEM for both whole count matrices; both CUDA entries hold
    fixed tiles (8.5 KB of shared memory for a read block, 2 KB for a count
    block) whatever the shape, so they have no size gate."""
    if not (cfg.fuse_bwd_update and cfg.use_pallas and cfg.fast_rng):
        return False
    if cfg.tile_grid is not None and tuple(cfg.tile_grid) != (1, 1):
        return False
    if management.bm_is_iterative(cfg):
        return False                      # iterative BM is multi-launch
    return w_shape[0] <= cfg.max_array_rows


def _read_and_streams(w, d2d, x2d, nm_s, read_seeds, upd_seeds, gains, *,
                      sigma, alpha, two_phase, retry_scale, bl, row0=0):
    z, sat = managed_mvm_plain(w, d2d, nm_s, read_seeds, sigma=sigma,
                               alpha=alpha, transpose=True,
                               two_phase=two_phase, retry_scale=retry_scale)
    a = update_lib.signed_streams(upd_seeds[0], x2d, gains[0], bl,
                                  row_offset=row0)
    b = update_lib.signed_streams(upd_seeds[1], -d2d, gains[1], bl,
                                  row_offset=row0)
    return (z, sat) + update_lib.coincidence_counts(b, a)


def bwd_update_mvm_plain(w, d2d, x2d, nm_s, read_seeds, upd_seeds, gains, *,
                         sigma: float, alpha: float, two_phase: bool,
                         retry_scale: float = 16.0, bl: int = 10):
    """Plain PyTorch version of the dense entry (``upd_seeds`` = seed of
    ``k_a``, seed of ``k_b``, row offset)."""
    return _read_and_streams(w, d2d, x2d, nm_s, read_seeds, upd_seeds,
                             gains, sigma=sigma, alpha=alpha,
                             two_phase=two_phase, retry_scale=retry_scale,
                             bl=bl, row0=upd_seeds[2])


def conv_bwd_update_plain(w, xpad, delta_rep, geom, nm_s, read_seeds,
                          upd_seeds, gains, *, sigma: float, alpha: float,
                          two_phase: bool, retry_scale: float = 16.0,
                          bl: int = 10):
    """Plain PyTorch version of the conv entry: the column drivers are the
    gathered im2col columns (channel-major, bias last)."""
    return _read_and_streams(w, delta_rep, gather_columns(xpad, geom), nm_s,
                             read_seeds, upd_seeds, gains, sigma=sigma,
                             alpha=alpha, two_phase=two_phase,
                             retry_scale=retry_scale, bl=bl)


_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
         ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
         ctypes.c_uint32]


def _lib(entry: str):
    fn = getattr(build.load("bwd_update_mvm"), entry)
    if fn.argtypes is None:
        if entry == "bwd_update_dense_launch":
            fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                           + _TAIL + [ctypes.c_uint32, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 2
                           + _TAIL + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _outputs(b: int, m_phys: int, n_cols: int, two_phase: bool, dev):
    f32 = torch.float32
    z = torch.empty(b, n_cols, dtype=f32, device=dev)
    residual = torch.empty(b, dtype=torch.int32, device=dev)
    acc1 = torch.empty(b, n_cols, dtype=f32, device=dev)
    acc2 = torch.empty_like(acc1) if two_phase else acc1
    flags = torch.empty(2, b, dtype=torch.int32, device=dev)
    up = torch.empty(m_phys, n_cols, dtype=f32, device=dev)
    dn = torch.empty_like(up)
    return z, residual, acc1, acc2, flags, up, dn


def _read_args(sigma, alpha, read_seeds, two_phase, retry_scale, upd_seeds):
    return (float(sigma), float(alpha), int(math.isfinite(alpha)),
            int(read_seeds[0]) & _M32, int(read_seeds[1]) & _M32,
            int(two_phase), float(retry_scale), int(upd_seeds[0]) & _M32,
            int(upd_seeds[1]) & _M32)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def bwd_update_mvm(w: torch.Tensor, d2d: torch.Tensor, x2d: torch.Tensor,
                   nm_s: torch.Tensor, read_seeds: Sequence[int],
                   upd_seeds: Sequence[int], gains: torch.Tensor, *,
                   sigma: float, alpha: float, two_phase: bool,
                   retry_scale: float = 16.0, bl: int = 10):
    """Fused backward+update of a dense tile ``w`` (m_phys, n_cols): the
    managed transpose read of the replicated errors ``d2d`` (B, m_phys)
    with NM scale ``nm_s`` (B, 1) and two read seeds, and the counts of the
    streams of ``x2d`` (B, n_cols) and ``-d2d`` with ``upd_seeds`` (seed of
    k_a, seed of k_b, row offset) and ``gains`` (2,) = (C_x, C_d) on the
    device.  Returns ``(z (B, n_cols), residual (B,), count_up, count_dn)``
    with ``z`` on physical columns and counts ``(m_phys, n_cols)``."""
    global launches
    m_phys, n_cols = w.shape
    b = d2d.shape[0]
    if d2d.shape != (b, m_phys) or x2d.shape != (b, n_cols):
        raise ValueError(f"d {tuple(d2d.shape)} / x {tuple(x2d.shape)} do "
                         f"not match w {tuple(w.shape)}")
    if not w.is_cuda:
        return bwd_update_mvm_plain(
            w, d2d, x2d, nm_s, read_seeds, upd_seeds, gains, sigma=sigma,
            alpha=alpha, two_phase=two_phase, retry_scale=retry_scale, bl=bl)
    nm = nm_s.reshape(b)
    check_operands(w, d2d, x2d, nm, gains)
    z, residual, acc1, acc2, flags, up, dn = _outputs(
        b, m_phys, n_cols, two_phase, w.device)
    rc = _lib("bwd_update_dense_launch")(
        w.data_ptr(), d2d.data_ptr(), x2d.data_ptr(), nm.data_ptr(),
        gains.data_ptr(), z.data_ptr(), residual.data_ptr(), acc1.data_ptr(),
        acc2.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
        up.data_ptr(), dn.data_ptr(), b, m_phys, n_cols, int(bl),
        *_read_args(sigma, alpha, read_seeds, two_phase, retry_scale,
                    upd_seeds),
        int(upd_seeds[2]) & _M32,
        torch.cuda.current_stream(w.device).cuda_stream)
    _check(rc, "bwd_update_mvm")
    launches += 1
    return z, residual != 0, up, dn


def conv_bwd_update(w: torch.Tensor, xpad: torch.Tensor,
                    delta_rep: torch.Tensor, geom, nm_s: torch.Tensor,
                    read_seeds: Sequence[int], upd_seeds: Sequence[int],
                    gains: torch.Tensor, *, sigma: float, alpha: float,
                    two_phase: bool, retry_scale: float = 16.0, bl: int = 10):
    """Fused backward+update of a conv tile ``w`` (m_phys, C*kh*kw [+1]),
    channel-major: as :func:`bwd_update_mvm` over the P = B*OH*OW position
    rows ``delta_rep`` (P, m_phys), the column drivers built by index from
    the padded volume ``xpad`` (B, H, W, C); ``upd_seeds`` = (seed of k_a,
    seed of k_b).  Counts come out channel-major."""
    global conv_launches
    m_phys, n_cols = w.shape
    p = geom.positions
    if n_cols != geom.cols or tuple(delta_rep.shape) != (p, m_phys):
        raise ValueError(f"w {tuple(w.shape)} / delta {tuple(delta_rep.shape)}"
                         f" do not match {geom}")
    if tuple(xpad.shape) != (geom.b, geom.h, geom.w, geom.c):
        raise ValueError(f"xpad {tuple(xpad.shape)} does not match {geom}")
    if not w.is_cuda:
        return conv_bwd_update_plain(
            w, xpad, delta_rep, geom, nm_s, read_seeds, upd_seeds, gains,
            sigma=sigma, alpha=alpha, two_phase=two_phase,
            retry_scale=retry_scale, bl=bl)
    nm = nm_s.reshape(p)
    check_operands(w, delta_rep, xpad, nm, gains)
    z, residual, acc1, acc2, flags, up, dn = _outputs(
        p, m_phys, n_cols, two_phase, w.device)
    g = geom_array(geom)                  # host ints, read during the call
    rc = _lib("bwd_update_conv_launch")(
        w.data_ptr(), delta_rep.data_ptr(), xpad.data_ptr(),
        ctypes.addressof(g), nm.data_ptr(), gains.data_ptr(), z.data_ptr(),
        residual.data_ptr(), acc1.data_ptr(), acc2.data_ptr(),
        flags[0].data_ptr(), flags[1].data_ptr(), up.data_ptr(),
        dn.data_ptr(), m_phys, int(bl),
        *_read_args(sigma, alpha, read_seeds, two_phase, retry_scale,
                    upd_seeds),
        torch.cuda.current_stream(w.device).cuda_stream)
    _check(rc, "conv_bwd_update")
    conv_launches += 1
    return z, residual != 0, up, dn
