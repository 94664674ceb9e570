"""conv_mvm: the implicit-im2col managed conv read — every output position's
managed read of a conv layer's crossbar, without an im2col matrix.

Replaces the TPU kernel ``conv_managed_mvm_pallas`` (``src/repro/kernels/
conv_mvm.py:157``, ``pallas_call`` at :198) with the CUDA kernel
``csrc/conv_mvm.cu``: the 64 x 64 tiled managed read over the flattened
position axis, its loader building each patch element by index from the
padded activation volume, the channel-major weights read directly, and the
shared select/average epilogue (two launches).  Noise counters are those of
the materialized column matrix, ``(img * OH*OW + pos) * out_phys + o``.
Bound: launches, at LeNet's shapes (see the source's header note).

:func:`conv_managed_mvm` launches it for CUDA tensors and runs
:func:`conv_managed_mvm_plain` — the TPU kernel's tap-major patch and weight
layout, then the managed read of ``kernels/managed_mvm.py`` — only for CPU
tensors.  ``launches`` counts conv reads.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.core import management
from repro_torch.kernels import build
from repro_torch.kernels.managed_mvm import managed_mvm_plain
from repro_torch.kernels.noisy_mvm import check_operands

_M32 = 0xFFFFFFFF

#: Conv reads launched since the last reset (``ops.reset_launch_counts``).
launches = 0


def conv_kernel_eligible(cfg, geom, w_shape: Tuple[int, int]) -> bool:
    """True when the implicit-im2col kernel takes the conv forward: kernels
    on, fixed-latency BM (off / two-phase), no tile grid, and one physical
    contraction segment.  The TPU kernel also gates on 8 MB of VMEM for a
    whole image; the CUDA kernel stages fixed 64 x 64 tiles (8.5 KB of
    shared memory) whatever the shape, so it has no size gate."""
    if not cfg.use_pallas:
        return False
    if cfg.tile_grid is not None and tuple(cfg.tile_grid) != (1, 1):
        return False
    if management.bm_is_iterative(cfg):
        return False                      # iterative BM is multi-launch
    return geom.cols <= cfg.max_array_cols


def assemble_patch(xpad: torch.Tensor, geom) -> torch.Tensor:
    """Implicit im2col in the TPU kernel's layout: the ``(positions,
    kh*kw*C [+1])`` patch matrix in tap-major column order (``t * C + c``,
    bias ones last), from the ``kh*kw`` strided tap slices."""
    taps = [geom.tap_slice(xpad, ih, iw).reshape(geom.positions, geom.c)
            for ih, iw in geom.taps]
    if geom.bias:
        taps.append(torch.ones(geom.positions, 1, dtype=xpad.dtype,
                               device=xpad.device))
    return torch.cat(taps, dim=1)


def tap_major_weights(w: torch.Tensor, geom) -> torch.Tensor:
    """The channel-major ``(M_phys, C*kh*kw [+1])`` parameter matrix with
    its columns in tap-major order (``t * C + c``, bias last)."""
    m = w.shape[0]
    kk = geom.kh * geom.kw
    w_tm = w[:, :geom.features].reshape(m, geom.c, kk).transpose(1, 2)
    w_tm = w_tm.reshape(m, kk * geom.c)
    if geom.bias:
        w_tm = torch.cat([w_tm, w[:, geom.features:]], dim=1)
    return w_tm.contiguous()


def conv_managed_mvm_plain(w: torch.Tensor, xpad: torch.Tensor, geom,
                           nm_s: torch.Tensor, seeds: Sequence[int], *,
                           sigma: float, alpha: float,
                           two_phase: bool = False, retry_scale: float = 16.0,
                           d_avg: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the tap-major patch matrix read by the managed
    read (same counters: the position row times the physical output)."""
    return managed_mvm_plain(
        tap_major_weights(w, geom), assemble_patch(xpad, geom), nm_s, seeds,
        sigma=sigma, alpha=alpha, two_phase=two_phase,
        retry_scale=retry_scale, d_avg=d_avg)


def geom_array(geom) -> "ctypes.Array":
    """The geometry as the kernels' host int array (B, H, W, C, kh, kw, sh,
    sw, dh, dw, oh, ow, bias)."""
    vals = (geom.b, geom.h, geom.w, geom.c, geom.kh, geom.kw, geom.sh,
            geom.sw, geom.dh, geom.dw, geom.oh, geom.ow, int(geom.bias))
    return (ctypes.c_int * len(vals))(*vals)


def _lib():
    fn = build.load("conv_mvm").conv_managed_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv_managed_mvm(w: torch.Tensor, xpad: torch.Tensor, geom,
                     nm_s: torch.Tensor, seeds: Sequence[int], *,
                     sigma: float, alpha: float, two_phase: bool = False,
                     retry_scale: float = 16.0, d_avg: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Managed conv read of ``w`` (d_avg * out_f, C*kh*kw [+1]) over the
    padded volume ``xpad`` (B, H, W, C) with the per-position scale ``nm_s``
    (P, 1) and the two u32 read seeds.  Returns ``y`` (P, out_f) and the
    residual flag (P,) bool, P = B*OH*OW."""
    global launches
    out_phys = w.shape[0]
    if w.dim() != 2 or w.shape[1] != geom.cols:
        raise ValueError(f"w {tuple(w.shape)} does not match {geom}")
    if tuple(xpad.shape) != (geom.b, geom.h, geom.w, geom.c):
        raise ValueError(f"xpad {tuple(xpad.shape)} does not match {geom}")
    if out_phys % d_avg:
        raise ValueError(f"{out_phys} physical outputs, d_avg={d_avg}")
    if not w.is_cuda:
        return conv_managed_mvm_plain(
            w, xpad, geom, nm_s, seeds, sigma=sigma, alpha=alpha,
            two_phase=two_phase, retry_scale=retry_scale, d_avg=d_avg)
    p = geom.positions
    nm = nm_s.reshape(p)
    check_operands(w, xpad, nm)
    dev = w.device
    y = torch.empty(p, out_phys // d_avg, dtype=torch.float32, device=dev)
    residual = torch.empty(p, dtype=torch.int32, device=dev)
    acc1 = torch.empty(p, out_phys, dtype=torch.float32, device=dev)
    acc2 = torch.empty_like(acc1) if two_phase else acc1
    flags = torch.empty(2, p, dtype=torch.int32, device=dev)
    g = geom_array(geom)                  # host ints, read during the call
    rc = _lib()(
        w.data_ptr(), xpad.data_ptr(), ctypes.addressof(g),
        nm.data_ptr(), y.data_ptr(), residual.data_ptr(), acc1.data_ptr(),
        acc2.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
        out_phys, d_avg, float(sigma), float(alpha),
        int(math.isfinite(alpha)), int(seeds[0]) & _M32,
        int(seeds[1]) & _M32, int(two_phase), float(retry_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_mvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, residual != 0
