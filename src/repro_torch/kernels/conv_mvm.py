"""conv_mvm: the implicit-im2col managed conv read — every output position's
managed read of a conv layer's crossbar, without an im2col matrix.

Replaces the TPU kernel ``conv_managed_mvm_pallas`` (``src/repro/kernels/
conv_mvm.py:157``, ``pallas_call`` at :198) with the CUDA kernel
``csrc/conv_mvm.cu``: the managed read's SIMT tile (``csrc/managed_gemm.cuh``)
over the flattened position axis, its loader building each patch element
by index from the padded activation volume, the channel-major weights read
directly, one launch per read.  :func:`plan` takes a tile as wide as the
physical outputs where one block can hold them all (K1's 16, K2's 32): the
block then runs the select / average itself.  Wider arrays (K2 with 13
devices per weight, 416) take 64x128 tiles, and the last block of each row
block runs the select for its rows.  Noise counters are those of the
materialized column matrix, ``(img * OH*OW + pos) * out_phys + o``.
Bound: the launch, at LeNet's shapes (see the source's header note).

:func:`conv_managed_mvm` launches it for CUDA tensors and runs
:func:`conv_managed_mvm_plain` — the TPU kernel's tap-major patch and weight
layout, then the managed read of ``kernels/managed_mvm.py`` — only for CPU
tensors.  ``launches`` counts conv reads.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import management
from repro_torch.kernels import build
from repro_torch.kernels.gemm import SMS, scratch, seed_arg
from repro_torch.kernels.managed_mvm import managed_mvm_plain
from repro_torch.kernels.noisy_mvm import check_operands
from repro_torch.utils import fastrng

_M32 = 0xFFFFFFFF

#: Conv reads launched since the last reset (``ops.reset_launch_counts``).
launches = 0


def conv_kernel_eligible(cfg, geom, w_shape: Tuple[int, int]) -> bool:
    """True when the implicit-im2col kernel takes the conv forward: kernels
    on, fixed-latency BM (off / two-phase), no tile grid, and one physical
    contraction segment.  The TPU kernel also gates on 8 MB of VMEM for a
    whole image; the CUDA kernel stages fixed tiles of 16-deep k-slices
    (at most 33 KB of shared memory) whatever the shape, so it has no
    size gate."""
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
                           nm_s: torch.Tensor,
                           seeds: Sequence[fastrng.Seed], *,
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


class Plan(NamedTuple):
    """The kernel's tile (tile_m positions x tile_n physical outputs, 4x4
    outputs per thread); ``one``: a block holds every physical output of
    its positions and runs the select itself; ``parts``: the contraction in
    that many ordered parts, blocks of their own."""
    tile_m: int
    tile_n: int
    one: bool
    parts: int


#: Tiles whose block holds every physical output (out_phys <= tile_n), the
#: narrowest that fits first; wider arrays take CROSS_TILE.
ONE_TILES = ((64, 16), (32, 32), (64, 64))
CROSS_TILE = (32, 32)
#: Blocks the parts aim for (four per SM: the tiles are small), the most
#: parts and the least depth of a part (8 k-tiles of 16: shallower parts
#: made K2's reads slower on an H100, the last block adding more planes).
PARTS_TARGET, MAX_PARTS, MIN_PART_DEPTH = 4 * SMS, 8, 128


def plan(out_phys: int, k_dim: int, positions: int) -> Plan:
    """The narrowest tile that holds ``out_phys`` physical outputs in one
    block, else CROSS_TILE with the select in the last block of each row
    tile; the contraction of ``k_dim`` split into the fewest parts that
    give the card PARTS_TARGET blocks, at most MAX_PARTS, each at least
    MIN_PART_DEPTH deep."""
    tile = next(((tm, tn, True) for tm, tn in ONE_TILES if out_phys <= tn),
                (*CROSS_TILE, False))
    tiles = -(-positions // tile[0]) * -(-out_phys // tile[1])
    parts = max(1, min(-(-PARTS_TARGET // tiles), MAX_PARTS,
                       k_dim // MIN_PART_DEPTH))
    return Plan(*tile, parts)


_GEOMS: Dict[object, "ctypes.Array"] = {}


def geom_array(geom) -> "ctypes.Array":
    """The geometry as the kernels' host int array (B, H, W, C, kh, kw, sh,
    sw, dh, dw, oh, ow, bias), made once per geometry."""
    arr = _GEOMS.get(geom)
    if arr is None:
        vals = (geom.b, geom.h, geom.w, geom.c, geom.kh, geom.kw, geom.sh,
                geom.sw, geom.dh, geom.dw, geom.oh, geom.ow, int(geom.bias))
        arr = _GEOMS[geom] = (ctypes.c_int * len(vals))(*vals)
    return arr


def _lib():
    fn = build.load("conv_mvm").conv_managed_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def conv_managed_mvm(w: torch.Tensor, xpad: torch.Tensor, geom,
                     nm_s: torch.Tensor, seeds: Sequence[fastrng.Seed], *,
                     sigma: float, alpha: float, two_phase: bool = False,
                     retry_scale: float = 16.0, d_avg: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Managed conv read of ``w`` (d_avg * out_f, C*kh*kw [+1]) over the
    padded volume ``xpad`` (B, H, W, C) with the per-position scale ``nm_s``
    (P, 1) and the two u32 read seeds (ints or device words, as
    ``managed_mvm.managed_mvm`` takes them).  Returns ``y`` (P, out_f) and
    the residual flag (P,) bool, P = B*OH*OW."""
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
    if nm_s.numel() != p:
        raise ValueError(f"nm_s {tuple(nm_s.shape)} is not one scale per "
                         f"position ({p})")
    check_operands(w, xpad, nm_s)
    dev = w.device
    y = torch.empty(p, out_phys // d_avg, dtype=torch.float32, device=dev)
    residual = torch.empty(p, dtype=torch.bool, device=dev)
    tp = plan(out_phys, geom.cols, p)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags = part = 0
    if not tp.one or tp.parts > 1:
        n = p * out_phys
        row_tiles = -(-p // tp.tile_m)
        tiles = row_tiles * -(-out_phys // tp.tile_n)
        fl, pt = scratch(dev, stream, 4 + 2 * p + row_tiles + tiles,
                         ((2 if two_phase else 1)
                          + (tp.parts if tp.parts > 1 else 0)) * n)
        flags, part = fl.data_ptr(), pt.data_ptr()
    (s1, s1_at), (s2, s2_at) = (seed_arg(s, dev) for s in seeds[:2])
    rc = _lib()(
        w.data_ptr(), xpad.data_ptr(), ctypes.addressof(geom_array(geom)),
        nm_s.data_ptr(), y.data_ptr(), residual.data_ptr(), part, flags,
        out_phys, d_avg, float(sigma), float(alpha),
        int(math.isfinite(alpha)), s1, s2, int(two_phase),
        float(retry_scale), tp.tile_m, tp.tile_n, int(tp.one), tp.parts,
        s1_at, s2_at, stream)
    if rc != 0:
        raise RuntimeError(f"conv_mvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, residual
