"""noisy_mvm: the raw analog array read, ``y = sum_seg clip(W_seg x_seg +
sigma * xi, +-alpha)`` with a per-row saturation flag.

Replaces the TPU kernel ``noisy_mvm_pallas`` (``src/repro/kernels/
noisy_mvm.py:127``, ``pallas_call`` at :197) with the CUDA kernel
``csrc/noisy_mvm.cu``, which runs on the managed read's product
(``csrc/managed_gemm.cuh``) with the raw read in place of the managed one,
one launch per read.  :func:`plan` picks its path from the shapes:

* decode (forward, B <= 8): a gemv streams W with float4 loads (x through
  L1); a warp owns whole columns over every segment, so it adds the noise,
  clips and writes y.  Bound: the bytes of W.
* everything else (prefill, transpose): the SIMT SGEMM tile (8x8 outputs
  per thread, or 4x4 in 32x32 tiles for short contractions; IEEE FMAs, no
  TF32), a block per tile, contraction segment and ``split``: the
  segment's contraction in ordered parts that the last block of the tile
  adds before the noise, where the tiles alone would not balance the
  card.  Bound: fp32 FMAs.

The saturation flags are ORed into a scratch per device and stream that
every call leaves zeroed (``kernels/gemm.py``); the last block writes the
(B,) flags as bytes.  The seed goes by value or, for a key tape's seed, by
its address (``gemm.seed_arg``); a read may carry a predicate ``go``, a
0-d bool device tensor that the kernel reads when it runs and, where it is
false, returns at once (a bound-management retry that the card skips,
``core/management.py``).  :func:`noisy_mvm` launches the kernel for CUDA
tensors and runs :func:`noisy_mvm_plain`, the same function in plain
PyTorch, only for CPU tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm import (
    GEMV_MAXB, SMS, scratch, seed_arg, tile_shape, vec_rows)
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


#: Operands of fewer rows take another product path in the CPU's matmul
#: (MKL), which adds a row's products in another order than for taller
#: ones; at this many rows and more every row sums alike.
CPU_MIN_ROWS = 16


def chunk_layout(x2d: torch.Tensor, row_offset: Optional[int],
                 total_rows: int) -> Tuple[torch.Tensor, slice]:
    """``x2d``, a chunk of rows ``row_offset ..`` of a ``total_rows``-row
    read, laid out for the plain products so that each row sums as in the
    whole read, and the slice of its rows in the products: a chunk of
    fewer than :data:`CPU_MIN_ROWS` rows is zero-padded to that many (or,
    when the whole read is that short, placed at its rows in a read of the
    whole's height).  The kernels do the same by their plan."""
    b = x2d.shape[0]
    if total_rows <= b or b >= CPU_MIN_ROWS:
        return x2d, slice(0, b)
    off = int(row_offset or 0) if total_rows < CPU_MIN_ROWS else 0
    xp = x2d.new_zeros(min(total_rows, CPU_MIN_ROWS), x2d.shape[1])
    xp[off:off + b] = x2d
    return xp, slice(off, off + b)


def counters(rows: torch.Tensor, si: int, n_seg: int, out_dim: int
             ) -> torch.Tensor:
    """Flat u32 noise counters ``(row * n_seg + si) * out + col`` (int64)."""
    cols = torch.arange(out_dim, dtype=torch.int64, device=rows.device)
    base = ((rows * n_seg + si) & _M32) * out_dim
    return (base[:, None] + cols[None, :]) & _M32


def read_segment(v: torch.Tensor, seed_mixed: fastrng.Seed,
                 e: torch.Tensor, n_total: int, sigma: float, alpha: float
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


def noisy_mvm_plain(w: torch.Tensor, x2d: torch.Tensor,
                    seed: fastrng.Seed, *, sigma: float, alpha: float,
                    n_seg: int = 1, transpose: bool = False,
                    row_offset: Optional[int] = None,
                    total_rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same counters, same order)."""
    out_dim = w.shape[1] if transpose else w.shape[0]
    k_dim = x2d.shape[1]
    b = x2d.shape[0]
    total_rows = b if total_rows is None else total_rows
    n_total = (total_rows * n_seg * out_dim) & _M32
    seed_m = fastrng.mix_seed(seed)
    rows = (torch.arange(b, dtype=torch.int64, device=x2d.device)
            + (0 if row_offset is None else int(row_offset))) & _M32
    xl, keep = chunk_layout(x2d, row_offset, total_rows)
    y = torch.zeros(b, out_dim, dtype=x2d.dtype, device=x2d.device)
    sat = torch.zeros(b, dtype=torch.bool, device=x2d.device)
    for si, (k0, k1) in enumerate(segments(k_dim, n_seg)):
        v = segment_product(w, xl, k0, k1, transpose)[keep]
        e = counters(rows, si, n_seg, out_dim) if sigma > 0.0 else None
        v, s = read_segment(v, seed_m, e, n_total, sigma, alpha)
        sat = sat | s
        y = y + v
    return y, sat


class Plan(NamedTuple):
    """How the kernel runs one read: ``path`` "gemv" or "tile" (tile_m x
    tile_n tiles, each segment's contraction in ``split`` ordered parts);
    ``ncw`` outputs per warp of the gemv; ``vec``: 16-byte loads (every row
    16-byte aligned), else aligned scalar loads.  Every read is one
    launch."""
    path: str
    tile_m: int
    tile_n: int
    ncw: int
    vec: bool
    split: int


#: Segments shorter than SHORT_SEG (LeNet's reads) take SHORT_TILE, with
#: 4x4 outputs per thread instead of 8x8: there each output's read noise
#: outweighs its multiply-adds, so more threads with fewer outputs each
#: finish sooner.
SHORT_SEG, SHORT_TILE = 1024, (32, 32)
#: Blocks the tiled path aims for: 1.5 per SM.
SPLIT_TARGET = 3 * SMS // 2
#: Most parts a segment's contraction is split into, and the least depth
#: of a part (8 k-tiles of 16).
MAX_SPLIT, MIN_SPLIT_DEPTH = 8, 128


def split_parts(blocks: int, seg_len: int) -> int:
    """Parts per segment for a grid of ``blocks`` tile blocks (tiles x
    segments): the fewest that give the card SPLIT_TARGET blocks, at most
    MAX_SPLIT, each part at least MIN_SPLIT_DEPTH deep.  More parts than
    that add planes for the last block to add and no speed on an H100 at
    deepseek's B = 128."""
    return max(1, min(-(-SPLIT_TARGET // blocks), MAX_SPLIT,
                      seg_len // MIN_SPLIT_DEPTH))


def plan(b: int, k_dim: int, out_dim: int, transpose: bool,
         aligned: bool = True, n_seg: int = 1) -> Plan:
    """The kernel's path for a read of ``b`` rows, contraction ``k_dim`` in
    ``n_seg`` segments and ``out_dim`` outputs; ``aligned``: both base
    pointers 16-byte aligned.  The gemv and the tile shapes are the
    managed read's (``managed_mvm.plan``) but for short segments
    (SHORT_TILE); the tiled path adds the split.  A chunk of a larger read
    is planned at the whole read's ``b`` (its ``total_rows``): the path and
    the split fix the order in which a row's products add, and a tile's
    shape does not change it."""
    vec = vec_rows(aligned, k_dim, out_dim, transpose)
    if not transpose and b <= GEMV_MAXB:
        return Plan("gemv", 0, 0, 2 if out_dim >= 4096 else 1, vec, 1)
    tm, tn = (SHORT_TILE if -(-k_dim // n_seg) < SHORT_SEG
              else tile_shape(b, out_dim, n_seg))
    blocks = -(-b // tm) * -(-out_dim // tn) * n_seg
    return Plan("tile", tm, tn, 0, vec,
                split_parts(blocks, -(-k_dim // n_seg)))


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p] * 3


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


def noisy_mvm(w: torch.Tensor, x2d: torch.Tensor, seed: fastrng.Seed, *,
              sigma: float, alpha: float, n_seg: int = 1,
              transpose: bool = False, row_offset: Optional[int] = None,
              total_rows: Optional[int] = None,
              go: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw read of ``w`` (R, C) by ``x2d`` (B, C) — or (B, R) when
    ``transpose`` — with u32 ``seed`` (an int, or a 0-d int64 tensor on
    the device).  Returns ``y`` (B, out) and the per-row saturation flag
    (B,) bool; with ``go`` (a 0-d bool tensor) both are left undefined
    when it is false (the plain version reads all the same)."""
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
    dev = w.device
    seed_v, seed_at = seed_arg(seed, dev)
    if go is not None and (go.dtype != torch.bool or go.numel() != 1
                           or go.device != dev):
        raise ValueError(f"the read's predicate is one bool on {dev}, got "
                         f"{go.dtype} {tuple(go.shape)} on {go.device}")
    b = x2d.shape[0]
    total_rows = b if total_rows is None else total_rows
    y = torch.empty(b, out_dim, dtype=torch.float32, device=dev)
    sat = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return y, sat
    # planned as the whole read that this one may be a chunk of: every
    # row then sums its products in the whole read's order
    p = plan(max(b, total_rows), k_dim, out_dim, transpose,
             w.data_ptr() % 16 == 0 and x2d.data_ptr() % 16 == 0, n_seg)
    parts = n_seg * p.split if p.path == "tile" else 1
    tiles = (-(-b // p.tile_m) * -(-out_dim // p.tile_n)
             if p.path == "tile" else 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags, part = scratch(dev, stream, 4 + b + tiles,
                          parts * b * out_dim if parts > 1 else 0)
    rc = _lib()(
        w.data_ptr(), x2d.data_ptr(), y.data_ptr(), sat.data_ptr(),
        flags.data_ptr(), part.data_ptr(), b, k_dim, out_dim, n_seg,
        -(-k_dim // n_seg), int(transpose), float(sigma), float(alpha),
        int(math.isfinite(alpha)), seed_v,
        int(row_offset or 0) & _M32, (total_rows * n_seg * out_dim) & _M32,
        int(p.path == "tile"), p.tile_m, p.tile_n, p.ncw, int(p.vec),
        p.split, seed_at, None if go is None else go.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"noisy_mvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, sat
