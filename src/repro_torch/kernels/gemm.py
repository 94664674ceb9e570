"""Host side of the read kernels' shared product (``csrc/managed_gemm.cuh``):
the tile shapes, the tile choice and the scratch per device and stream.

Kernels #1 (raw read), #2 (managed read) and #3 (conv read) run on that
product.  Each keeps its per-row saturation flags and last-block tickets in
an int32 scratch that every call leaves zeroed, and its partial sums in a
float32 scratch; reads on one stream run in order, so they share one
scratch per (device, stream).  Reads on two streams must not.

:func:`seed_arg` passes a seed as the managed reads (#2, #3) and the fused
backward+update (#6, #7) take it: by value, or by its address in device
memory (``Seed`` in ``csrc/analog_read.cuh``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.utils import fastrng

#: Streaming multiprocessors of the H100 (the grid a tile plan fills).
SMS = 132
#: Largest batch the decode (gemv) path takes.
GEMV_MAXB = 8
#: Tile shapes of the tiled path, largest first.
TILES = ((128, 128), (64, 128))

_M32 = 0xFFFFFFFF

_SCRATCH: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def vec_rows(aligned: bool, k_dim: int, out_phys: int,
             transpose: bool) -> bool:
    """16-byte loads: both base pointers 16-byte aligned (``aligned``) and
    every row length a multiple of 4 floats (x and W share k_dim; W's rows
    are out_phys long when transposed)."""
    return (aligned and k_dim % 4 == 0
            and (out_phys % 4 == 0 or not transpose))


def tile_shape(b: int, out_phys: int, n_seg: int) -> Tuple[int, int]:
    """128x128 tiles where a block per tile and segment gives every SM a
    block, else 64x128 (8x8 outputs per thread leave few threads at small
    batch)."""
    for tm, tn in TILES:
        if -(-b // tm) * -(-out_phys // tn) * n_seg >= SMS:
            break
    return tm, tn


def scratch(dev: torch.device, stream: int, ints: int, floats: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (int32 flags, float32 partials) scratch of ``stream`` on ``dev``
    with at least ``ints`` and ``floats`` elements, grown on demand.  The
    flags are zero between calls (a grown one starts zeroed)."""
    flags, part = _SCRATCH.get((dev, stream), (None, None))
    if flags is None or flags.numel() < ints:
        flags = torch.zeros(max(ints, 4 + 2 * GEMV_MAXB), dtype=torch.int32,
                            device=dev)
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    _SCRATCH[(dev, stream)] = (flags, part)
    return flags, part


def seed_arg(seed: fastrng.Seed, device: torch.device
             ) -> Tuple[int, Optional[int]]:
    """One u32 seed word as the kernels take it: ``(value, address)``.  A
    Python int goes by value (null address); a 0-d int64 tensor on
    ``device`` (a key tape's seed, ``utils/prng.py``) by its address, and
    the kernel reads the word when it runs."""
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int64 or seed.numel() != 1
                or seed.device != device):
            raise ValueError(f"a device seed is one int64 word on {device}, "
                             f"got {seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return 0, seed.data_ptr()
    return int(seed) & _M32, None
