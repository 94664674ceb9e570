"""Host side of the read kernels' shared product (``csrc/managed_gemm.cuh``):
the tile shapes, the tile choice and the scratch per device and stream.

Kernels #1 (raw read), #2 (managed read) and #3 (conv read) run on that
product.  Each keeps its per-row saturation flags and last-block tickets in
an int32 scratch that every call leaves zeroed, and its partial sums in a
float32 scratch; reads on one stream run in order, so they share one
scratch per (device, stream).  Reads on two streams must not.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: Streaming multiprocessors of the H100 (the grid a tile plan fills).
SMS = 132
#: Largest batch the decode (gemv) path takes.
GEMV_MAXB = 8
#: Tile shapes of the tiled path, largest first.
TILES = ((128, 128), (64, 128))

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
