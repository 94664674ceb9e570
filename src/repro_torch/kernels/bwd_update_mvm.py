"""bwd_update_mvm: the backward and update cycles of one analog layer in one
kernel launch — the managed transpose read of the replicated errors AND the
update's integer coincidence counts, with the pulse streams regenerated in
the kernel and never stored.

Replaces the TPU kernels ``bwd_update_mvm_pallas`` (``src/repro/kernels/
bwd_update_mvm.py:222``, ``pallas_call`` at :276; dense layers) and
``conv_bwd_update_pallas`` (:473, ``pallas_call`` at :526; conv layers,
column drivers assembled from the activation volume) with the two entries
of ``csrc/bwd_update_mvm.cu``: ONE launch per call, no memset, of a grid of
read blocks (the managed read's transposed tile, ``csrc/managed_gemm.cuh``,
with the select in the block or in the last block of a row tile) and count
blocks (device tiles x stream slots, int32 counts, exact).  :func:`plan`
splits both kinds of block for the card; flags, tickets and the counts'
cross-block sums live in the scratch per device and stream of
``kernels/gemm.py``, left zeroed.  The caller finishes the cycle with
``update.finalize_counts``.

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
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import management
from repro_torch.core import update as update_lib
from repro_torch.core.conv_mapping import gather_columns
from repro_torch.kernels import build
from repro_torch.kernels.conv_mvm import geom_array
from repro_torch.kernels.gemm import SMS, scratch, seed_arg
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
    on 8 MB of VMEM for both whole count matrices; the CUDA blocks hold
    fixed tiles (9 KB of shared memory) whatever the shape, so it has no
    size gate."""
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
    cols = gather_columns(xpad, geom, 0, geom.positions)
    return _read_and_streams(w, delta_rep, cols, nm_s,
                             read_seeds, upd_seeds, gains, sigma=sigma,
                             alpha=alpha, two_phase=two_phase,
                             retry_scale=retry_scale, bl=bl)


class Plan(NamedTuple):
    """How the kernel runs one call.  Read blocks: tile_m x tile_n tiles of
    the transpose read (4x4 outputs per thread); ``one``: a block holds
    every column of its rows and selects itself; the contraction in
    ``read_parts`` ordered parts of ``read_len`` rows.  Count blocks: 32 x
    32 device tiles, the B*BL stream slots in ``slot_parts`` parts of
    ``slot_len``; ``sum_planes``: the parts' counts meet in a plane per
    part, else in atomic sums.  ``ints`` / ``floats``: the scratch the
    call needs."""
    tile_m: int
    tile_n: int
    one: bool
    read_len: int
    read_parts: int
    slot_len: int
    slot_parts: int
    sum_planes: bool
    ints: int
    floats: int


#: The read tile: 64 threads, the count blocks' size too.
TILE = (32, 32)
#: Device tile side of a count block, and the stream slots it stages per
#: round (``csrc/pulse_stream.cuh``: CT, CR).
COUNT_TILE, SLOT_ROUND = 32, 64
#: Blocks each kind aims for: four of 64 threads per SM.
BLOCKS_TARGET = 4 * SMS
#: Most parts of the read's contraction and the least depth of one (8
#: k-tiles of 16, as the conv read's); the least and the most slots of a
#: count part (one and four staging rounds).
MAX_READ_PARTS, MIN_PART_DEPTH = 8, 128
MIN_SLOTS, MAX_SLOTS = SLOT_ROUND, 4 * SLOT_ROUND
#: Most slot parts whose counts meet in planes (each part writes one, the
#: last adds them); more meet in atomic sums (on an H100 planes were
#: faster at K2 with 13 devices per weight, 4 parts at each of 169 tiles,
#: and far slower at K1's 72 or 360 parts at one tile).
MAX_PLANE_PARTS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(rows: int, m_phys: int, n_cols: int, bl: int,
         two_phase: bool = True) -> Plan:
    """The plan of a call over ``rows`` error rows (B, or P positions) of a
    ``(m_phys, n_cols)`` tile at ``bl`` slots per row: each kind of block
    split into the fewest parts that give the card BLOCKS_TARGET of them —
    the read's contraction in at most MAX_READ_PARTS parts of at least
    MIN_PART_DEPTH rows, the stream slots in parts of MIN_SLOTS to
    MAX_SLOTS.  Runs on the host (no card needed)."""
    tm, tn = TILE
    one = n_cols <= tn
    row_tiles = _cdiv(rows, tm)
    tiles = row_tiles * _cdiv(n_cols, tn)
    parts = max(1, min(_cdiv(BLOCKS_TARGET, max(tiles, 1)), MAX_READ_PARTS,
                       m_phys // MIN_PART_DEPTH))
    read_len = _cdiv(_cdiv(m_phys, parts), 16) * 16
    read_parts = _cdiv(m_phys, read_len)
    count_tiles = _cdiv(m_phys, COUNT_TILE) * _cdiv(n_cols, COUNT_TILE)
    slots = rows * bl
    sp = max(1, min(max(_cdiv(BLOCKS_TARGET, count_tiles),
                        _cdiv(slots, MAX_SLOTS)), slots // MIN_SLOTS))
    slot_len = _cdiv(max(_cdiv(slots, sp), 1), SLOT_ROUND) * SLOT_ROUND
    slot_parts = max(1, _cdiv(slots, slot_len))
    planes = 1 < slot_parts <= MAX_PLANE_PARTS
    out = rows * n_cols
    sums = 2 * m_phys * n_cols
    ints = (2 * rows + row_tiles + tiles + count_tiles
            + (sums if slot_parts > 1 and not planes else 0))
    floats = ((out if two_phase and not one else 0)
              + (read_parts * out if read_parts > 1 else 0)
              + (slot_parts * sums if planes else 0))
    return Plan(tm, tn, one, read_len, read_parts, slot_len, slot_parts,
                planes, ints, floats)


_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
         ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
         ctypes.c_uint32]
# the plan, the four seed addresses, the stream
_PLAN = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5


def _lib(entry: str):
    fn = getattr(build.load("bwd_update_mvm"), entry)
    if fn.argtypes is None:
        if entry == "bwd_update_dense_launch":
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                           + _TAIL + [ctypes.c_uint32] + _PLAN)
        else:
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
                           + _TAIL + _PLAN)
        fn.restype = ctypes.c_int
    return fn


def _gains(gains) -> Tuple[torch.Tensor, ...]:
    """The tensors holding (C_x, C_d): one (2,) tensor or two 0-d ones."""
    if isinstance(gains, torch.Tensor):
        if gains.shape != (2,):
            raise ValueError(f"gains {tuple(gains.shape)} is not (C_x, C_d)")
        return (gains,)
    if len(gains) != 2 or any(g.numel() != 1 for g in gains):
        raise ValueError("gains must be (C_x, C_d)")
    return tuple(gains)


def _prepare(rows: int, m_phys: int, n_cols: int, bl: int, two_phase: bool,
             w: torch.Tensor, gains: Tuple[torch.Tensor, ...]):
    """The call's plan, its three outputs and the pointers of the gains and
    the scratch of this device and stream."""
    dev = w.device
    gx = gains[0].data_ptr()
    gd = gx + 4 if len(gains) == 1 else gains[1].data_ptr()
    p = plan(rows, m_phys, n_cols, int(bl), bool(two_phase))
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags, part = scratch(dev, stream, p.ints, p.floats)
    z = torch.empty(rows, n_cols, dtype=torch.float32, device=dev)
    residual = torch.empty(rows, dtype=torch.bool, device=dev)
    counts = torch.empty(2, m_phys, n_cols, dtype=torch.float32, device=dev)
    ptrs = (gx, gd, z.data_ptr(), residual.data_ptr(), counts.data_ptr(),
            flags.data_ptr(), part.data_ptr())
    return p, z, residual, counts, ptrs, stream


def _seeds(read_seeds, upd_seeds, dev):
    """The four seed words (two reads', two streams') as ``(values,
    addresses)``: ints by value, device words by address."""
    args = [seed_arg(s, dev) for s in (*read_seeds[:2], *upd_seeds[:2])]
    return [a[0] for a in args], [a[1] for a in args]


def _read_args(sigma, alpha, seeds, two_phase, retry_scale):
    r1, r2, sa, sb = seeds
    return (float(sigma), float(alpha), int(math.isfinite(alpha)), r1, r2,
            int(two_phase), float(retry_scale), sa, sb)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def bwd_update_mvm(w: torch.Tensor, d2d: torch.Tensor, x2d: torch.Tensor,
                   nm_s: torch.Tensor, read_seeds: Sequence[int],
                   upd_seeds: Sequence[int], gains, *,
                   sigma: float, alpha: float, two_phase: bool,
                   retry_scale: float = 16.0, bl: int = 10):
    """Fused backward+update of a dense tile ``w`` (m_phys, n_cols): the
    managed transpose read of the replicated errors ``d2d`` (B, m_phys)
    with NM scale ``nm_s`` (B, 1) and two read seeds, and the counts of the
    streams of ``x2d`` (B, n_cols) and ``-d2d`` with ``upd_seeds`` (seed of
    k_a, seed of k_b, row offset; every seed an int or a device word, as
    ``managed_mvm.managed_mvm`` takes them) and ``gains`` = (C_x, C_d) on
    the device (two 0-d tensors or one (2,) tensor).  Returns ``(z (B,
    n_cols), residual (B,) bool, count_up, count_dn)`` with ``z`` on
    physical columns and counts ``(m_phys, n_cols)``."""
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
    gt = _gains(gains)
    check_operands(w, d2d, x2d, nm, *gt)
    p, z, residual, counts, ptrs, stream = _prepare(
        b, m_phys, n_cols, bl, two_phase, w, gt)
    values, at = _seeds(read_seeds, upd_seeds, w.device)
    rc = _lib("bwd_update_dense_launch")(
        w.data_ptr(), d2d.data_ptr(), x2d.data_ptr(), nm.data_ptr(), *ptrs,
        b, m_phys, n_cols, int(bl),
        *_read_args(sigma, alpha, values, two_phase, retry_scale),
        int(upd_seeds[2]) & _M32, int(p.one), p.read_len, p.slot_len,
        int(p.sum_planes), *at, stream)
    _check(rc, "bwd_update_mvm")
    launches += 1
    return z, residual, counts[0], counts[1]


def conv_bwd_update(w: torch.Tensor, xpad: torch.Tensor,
                    delta_rep: torch.Tensor, geom, nm_s: torch.Tensor,
                    read_seeds: Sequence[int], upd_seeds: Sequence[int],
                    gains, *, sigma: float, alpha: float,
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
    gt = _gains(gains)
    check_operands(w, delta_rep, xpad, nm, *gt)
    tp, z, residual, counts, ptrs, stream = _prepare(
        p, m_phys, n_cols, bl, two_phase, w, gt)
    values, at = _seeds(read_seeds, upd_seeds, w.device)
    rc = _lib("bwd_update_conv_launch")(
        w.data_ptr(), delta_rep.data_ptr(), xpad.data_ptr(),
        ctypes.addressof(geom_array(geom)), nm.data_ptr(), *ptrs, m_phys,
        int(bl), *_read_args(sigma, alpha, values, two_phase, retry_scale),
        int(tp.one), tp.read_len, tp.slot_len, int(tp.sum_planes), *at,
        stream)
    _check(rc, "conv_bwd_update")
    conv_launches += 1
    return z, residual, counts[0], counts[1]
