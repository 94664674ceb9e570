"""Crossbar tile grids: one logical tile as a grid of physical sub-arrays.

The paper's Discussion caps one physical RPU array at 4096x4096 and realises
larger matrices as a *grid* of arrays whose partial reads are clipped, then
summed digitally.  A tile with ``cfg.tile_grid = (R, C)`` splits its
physical weights ``(#_d * out_f, in_f)`` into ``R`` row blocks (the output
dim of the forward read) and ``C`` column blocks (its contraction), each
ceil-divided; the padded array is ``(rows_pad, cols_pad)``.  Port of the
one-device part of the JAX package's ``core/tile_grid.py``:

* **read** (forward / transpose): block ``(i, j)`` is one raw analog read
  of its own (``tile.analog_mvm``: one launch of the raw-read kernel under
  ``cfg.use_pallas``) under ``fold_in(read_key, i * C + j)``; partial
  outputs add over the contraction blocks in index order (a left fold) and
  the saturation flag is the OR over every block.  NM and BM compose over
  the whole grid read (``management.with_management``): the NM scale comes
  once from the unsplit input, and every BM retry re-reads every block at
  the same scale; a predicated retry's ``go`` reaches every block's launch.
* **update**: the pulse streams are drawn once over the padded row and
  column drivers with the unpadded UM gains; one coincidence count over
  them (one launch of the pulse-count kernel under ``cfg.use_pallas``)
  holds every block's counts, since the counts are integers; then each
  block applies its maps, its ctoc noise under ``fold_in(k_c, i * C + j)``
  at counters within the block, and its bound clip.  With chunks
  (``cfg.update_chunk``, or the conv cycles' generated chunks) each chunk's
  padded streams are drawn at its rows' counters and counted, adding to
  the chunks' before it (one launch per chunk), and the one finalize pass
  follows the last: the bits of the unchunked grid update.

Padding: the physical array pads with zero weights and zero input lines.
Padded output rows are real integrator channels: they read pure noise,
drawn at the padded block's counters, and are sliced away after assembly.

The JAX package places the blocks on a device mesh with ``shard_map`` when
enough devices exist, with numerics identical to its serial form.  This
package has no ``distributed/``: every grid runs the serial form on one
card, whatever the number of cards.  The sharded forms are not ported.
The JAX package pads a chunked update's rows to whole chunks
(``_pad_chunk_rows``); the port's chunk loops run on the host, so its last
chunk is short instead, which counts the same pulses.

The weights are split into contiguous blocks once per managed read (a pad
where the shape does not divide, and a copy where the grid has more than
one column block), and the input once per grid read, so no block read
copies its operands.  The (1, 1) grid is the plain single-tile path
(``tile._grid_routed``), bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import management
from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Grid geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static geometry of one logical tile's sub-tile grid: ``grid_rows``
    blocks over the physical rows, ``grid_cols`` over the columns."""

    grid_rows: int
    grid_cols: int
    rows_phys: int
    cols: int

    @classmethod
    def for_tile(cls, w_shape: Tuple[int, int], cfg: RPUConfig) -> "TileGrid":
        gr, gc = cfg.tile_grid if cfg.tile_grid is not None else (1, 1)
        r, c = w_shape
        if not (1 <= gr <= r and 1 <= gc <= c):
            raise ValueError(
                f"tile_grid {(gr, gc)} invalid for physical array {(r, c)}")
        return cls(gr, gc, r, c)

    @property
    def n_blocks(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def block_rows(self) -> int:
        return -(-self.rows_phys // self.grid_rows)

    @property
    def block_cols(self) -> int:
        return -(-self.cols // self.grid_cols)

    @property
    def rows_pad(self) -> int:
        return self.grid_rows * self.block_rows

    @property
    def cols_pad(self) -> int:
        return self.grid_cols * self.block_cols

    def pad_w(self, w: Tensor) -> Tensor:
        pr, pc = self.rows_pad - self.rows_phys, self.cols_pad - self.cols
        return w if pr == pc == 0 else F.pad(w, (0, pc, 0, pr))

    def pad_last(self, x: Tensor, to: int) -> Tensor:
        pad = to - x.shape[-1]
        return x if pad == 0 else F.pad(x, (0, pad))


def _block_key(key: prng.AnyKey, flat_index: int,
               n_blocks: int) -> prng.AnyKey:
    """Per-block key ``fold_in(key, i * grid_cols + j)``; the (1, 1) grid
    keeps the caller's key, so a trivial grid reads as the plain tile."""
    if n_blocks == 1:
        return key
    return prng.fold_in(key, flat_index)


def weight_blocks(w: Tensor, g: TileGrid) -> List[List[Tensor]]:
    """The padded weights as ``blocks[i][j]`` of ``(block_rows,
    block_cols)``, each contiguous: row slices of the (padded) weights for
    one column block, else one blocked copy."""
    wp = g.pad_w(w)
    br, bc = g.block_rows, g.block_cols
    if g.grid_cols == 1:
        return [[wp[i * br:(i + 1) * br]] for i in range(g.grid_rows)]
    wb = wp.reshape(g.grid_rows, br, g.grid_cols, bc).transpose(1, 2)
    wb = wb.contiguous()
    return [[wb[i, j] for j in range(g.grid_cols)]
            for i in range(g.grid_rows)]


def _input_blocks(x: Tensor, n: int, width: int) -> List[Tensor]:
    """``x (..., k)`` padded to ``n * width`` and cut into ``n`` contiguous
    ``(rows, width)`` blocks (one copy for all of them)."""
    x2 = x.reshape(-1, x.shape[-1])
    pad = n * width - x2.shape[-1]
    if pad:
        x2 = F.pad(x2, (0, pad))
    if n == 1:
        return [x2]
    xb = x2.reshape(x2.shape[0], n, width).transpose(0, 1).contiguous()
    return list(xb.unbind(0))


# ---------------------------------------------------------------------------
# Raw grid read (one physical read per sub-tile, clip before digital sum)
# ---------------------------------------------------------------------------

def _grid_read(blocks: List[List[Tensor]], x: Tensor, key: prng.AnyKey,
               cfg: RPUConfig, g: TileGrid, *, transpose: bool,
               row_offset: Optional[int], total_rows: Optional[int],
               go: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    br, bc = g.block_rows, g.block_cols
    if transpose:
        out_dim, n_out, n_in, width = g.cols, g.grid_cols, g.grid_rows, br
    else:
        out_dim, n_out, n_in, width = g.rows_phys, g.grid_rows, g.grid_cols, bc
    batch_shape = x.shape[:-1]
    xs = _input_blocks(x, n_in, width)
    out_chunks, sat = [], None
    for o in range(n_out):
        y_o = None
        for k in range(n_in):
            i, j = (k, o) if transpose else (o, k)
            bk = _block_key(key, i * g.grid_cols + j, g.n_blocks)
            yb, satb = tile_lib.analog_mvm(blocks[i][j], xs[k], bk, cfg,
                                           transpose=transpose,
                                           row_offset=row_offset,
                                           total_rows=total_rows, go=go)
            y_o = yb if y_o is None else y_o + yb
            sat = satb if sat is None else sat | satb
        out_chunks.append(y_o)
    y = out_chunks[0] if n_out == 1 else torch.cat(out_chunks, dim=-1)
    y = y[..., :out_dim]
    return y.reshape(*batch_shape, out_dim), sat.reshape(batch_shape)


def grid_analog_mvm(w: Tensor, x: Tensor, key: prng.AnyKey, cfg: RPUConfig,
                    *, transpose: bool = False,
                    row_offset: Optional[int] = None,
                    total_rows: Optional[int] = None,
                    go: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The serial grid read: block ``(i, j)`` in row-major order is one raw
    read (``tile.analog_mvm``, so the raw-read kernel under
    ``cfg.use_pallas``; the plain grid read is this function with
    ``use_pallas`` off) under its fold_in key; partial outputs add over the
    contraction blocks in index order; the flag is the OR over every
    block.  ``go``: every block read's predicate."""
    g = TileGrid.for_tile(tuple(w.shape), cfg)
    return _grid_read(weight_blocks(w, g), x, key, cfg, g,
                      transpose=transpose, row_offset=row_offset,
                      total_rows=total_rows, go=go)


# ---------------------------------------------------------------------------
# Managed grid read and the tile cycles
# ---------------------------------------------------------------------------

def grid_managed_mvm(w: Tensor, x: Tensor, key: prng.AnyKey,
                     cfg: RPUConfig, *, transpose: bool = False,
                     backward: bool = False,
                     row_offset: Optional[int] = None,
                     total_rows: Optional[int] = None
                     ) -> Tuple[Tensor, Tensor]:
    """Managed (NM + BM) read over the tile grid: ``management.
    with_management`` with the grid read as the raw read, the weights
    split into blocks once for all of its reads.  Returns ``(y_phys,
    residual_sat)`` on physical output channels."""
    g = TileGrid.for_tile(tuple(w.shape), cfg)
    blocks = weight_blocks(w, g)

    def raw(xx, kk, go=None):
        return _grid_read(blocks, xx, kk, cfg, g, transpose=transpose,
                          row_offset=row_offset, total_rows=total_rows,
                          go=go)

    return management.with_management(raw, x, key, cfg, backward=backward)


def grid_tile_forward(w: Tensor, x: Tensor, key: prng.AnyKey,
                      cfg: RPUConfig, *, return_sat: bool = False,
                      row_offset: Optional[int] = None,
                      total_rows: Optional[int] = None):
    """Forward cycle on the grid; the #_d replica average follows the whole
    grid read (``tile.tile_forward``'s grid route)."""
    y_phys, sat = grid_managed_mvm(w, x, key, cfg, transpose=False,
                                   backward=False, row_offset=row_offset,
                                   total_rows=total_rows)
    y = tile_lib._replica_mean(y_phys, cfg.devices_per_weight)
    return (y, sat) if return_sat else y


def grid_tile_backward(w: Tensor, delta: Tensor, key: prng.AnyKey,
                       cfg: RPUConfig, *, return_sat: bool = False,
                       row_offset: Optional[int] = None,
                       total_rows: Optional[int] = None):
    """Backward (transpose) cycle on the grid; ``delta`` already carries
    the #_d-replicated physical row layout (``tile.replicate_delta``)."""
    z, sat = grid_managed_mvm(w, delta, key, cfg, transpose=True,
                              backward=True, row_offset=row_offset,
                              total_rows=total_rows)
    d = cfg.devices_per_weight
    if d > 1:
        z = tile_lib.div_replicas(z, d)
    return (z, sat) if return_sat else z


# ---------------------------------------------------------------------------
# The grid's update cycle
# ---------------------------------------------------------------------------

def _block_seeds(k_c: prng.AnyKey, g: TileGrid, device) -> Tensor:
    """The mixed ctoc seed of every block, ``(grid_rows, grid_cols)``
    int64: a stack of the key tape's seed views under a device key, else
    made from the host's words."""
    seeds = [fastrng.key_to_seed(_block_key(k_c, b, g.n_blocks))
             for b in range(g.n_blocks)]
    if isinstance(seeds[0], torch.Tensor):
        mixed = fastrng.mix_seed(torch.stack(seeds))
    else:
        mixed = torch.tensor([fastrng.mix_seed(s) for s in seeds],
                             dtype=torch.int64, device=device)
    return mixed.reshape(g.grid_rows, g.grid_cols)


def _finalize_blocks(w: Tensor, maps: DeviceMaps, count_up: Tensor,
                     count_dn: Tensor, k_c: prng.AnyKey, cfg: RPUConfig,
                     g: TileGrid) -> Tensor:
    """Every block's finalize of the padded counts in one pass over the
    unpadded tile: an entry's ctoc draw depends only on its block's seed,
    its counter ``r * block_cols + c`` within the block and the block's
    size, so this equals the JAX package's block-by-block finalize (padded
    entries, of zero dw and unit bound, are sliced away there)."""
    r, c = g.rows_phys, g.cols
    up, dn = count_up[:r, :c], count_dn[:r, :c]
    ctoc = cfg.dw_min_ctoc
    if ctoc > 0.0 and not cfg.fast_rng:
        raise NotImplementedError(
            "only the counter-hash ctoc noise (fast_rng=True) is ported")
    xi = None
    if ctoc > 0.0:
        br, bc = g.block_rows, g.block_cols
        rows = torch.arange(r, dtype=torch.int64, device=w.device)
        cols = torch.arange(c, dtype=torch.int64, device=w.device)
        seed = _block_seeds(k_c, g, w.device)[
            (rows // br)[:, None], (cols // bc)[None, :]]
        e = (rows % br)[:, None] * bc + (cols % bc)[None, :]
        xi = fastrng.normal_at(seed, e, br * bc)
    dw = update_lib.maps_dw(up, dn, maps.dw_up, maps.dw_dn, ctoc, xi)
    return torch.clamp(w + dw.to(cfg.dtype), -maps.bound, maps.bound)


def grid_pulse_update(w: Tensor, maps: DeviceMaps, x: Tensor, delta: Tensor,
                      key: prng.AnyKey, cfg: RPUConfig, lr: float) -> Tensor:
    """Grid update cycle.  ``delta`` already carries the physical
    (replicated) row layout.  The streams are drawn once over the padded
    drivers with the unpadded UM gains and counted at once (the counts of
    block ``(i, j)`` are the slice of the full counts); each block then
    finalizes under ``fold_in(k_c, i * grid_cols + j)``.  With
    ``cfg.update_chunk`` below the number of vector pairs, the counts
    accumulate over row chunks of the padded drivers first."""
    g = TileGrid.for_tile(tuple(w.shape), cfg)
    if x.dim() == 1:
        x, delta = x[None], delta[None]
    k_a, k_b, k_c = prng.split(key, 3)
    cx, cd = management.um_factors(x, delta, cfg, lr)
    xp = g.pad_last(x, g.cols_pad)
    dp = g.pad_last(delta, g.rows_pad)
    t = x.numel() // x.shape[-1]
    if cfg.update_chunk is not None and cfg.update_chunk < t:
        x2, d2 = xp.reshape(t, g.cols_pad), dp.reshape(t, g.rows_pad)
        return _grid_update_streamed_serial(
            w, maps, (x2, d2), update_lib.row_slices, cx, cd, k_a, k_b, k_c,
            cfg, g, t, cfg.update_chunk)
    count_up, count_dn = update_lib.stream_counts(xp, dp, cx, cd, k_a, k_b,
                                                  cfg)
    return _finalize_blocks(w, maps, count_up, count_dn, k_c, cfg, g)


def grid_pulse_update_streamed(w: Tensor, maps: DeviceMaps, src,
                               get_chunk: update_lib.GetChunk,
                               key: prng.AnyKey, cfg: RPUConfig, lr: float,
                               *, total: int, chunk: int,
                               um_maxima=None) -> Tensor:
    """Grid update over generated chunks (the streaming conv cycles):
    ``get_chunk(src, start, rows)`` makes one chunk of columns and
    replicated error rows, padded here to the grid's widths; as
    ``update.pulse_update_streamed``, which it serves."""
    g = TileGrid.for_tile(tuple(w.shape), cfg)
    k_a, k_b, k_c = prng.split(key, 3)
    cx, cd = update_lib.um_from_maxima(um_maxima, cfg, lr, w.device)

    def get_padded(s, start, n):
        cols, delta = get_chunk(s, start, n)
        return g.pad_last(cols, g.cols_pad), g.pad_last(delta, g.rows_pad)

    return _grid_update_streamed_serial(w, maps, src, get_padded, cx, cd,
                                        k_a, k_b, k_c, cfg, g, total, chunk)


def _grid_update_streamed_serial(w: Tensor, maps: DeviceMaps, src,
                                 get_padded, cx: Tensor, cd: Tensor,
                                 k_a: prng.AnyKey, k_b: prng.AnyKey,
                                 k_c: prng.AnyKey, cfg: RPUConfig,
                                 g: TileGrid, total: int, chunk: int
                                 ) -> Tensor:
    """The chunked grid update: each generated chunk's padded drivers have
    their streams drawn at the chunk's rows and counted (the JAX package's
    ``_gen_chunk_streams``), the counts adding up over the chunks (one
    count launch each); then :func:`_finalize_blocks`."""
    count_up, count_dn = update_lib.accumulate_counts(
        src, get_padded, total, chunk, cx, cd, k_a, k_b, cfg)
    return _finalize_blocks(w, maps, count_up, count_dn, k_c, cfg, g)
