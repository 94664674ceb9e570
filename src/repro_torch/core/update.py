"""Stochastic-pulse update cycle (Eq. 1) as coincidence counts.

The hardware streams ``BL`` pulse slots; column driver ``j`` fires with
probability ``min(|C_x x_j|, 1)`` (polarity ``sign(x_j)``), row driver ``i``
with probability ``min(|C_d d_i|, 1)`` (polarity ``sign(d_i)``).  A device
increments by ``dw_up`` on a coincidence of equal polarity and decrements by
``dw_dn`` otherwise, with cycle-to-cycle variation per event.  With signed
streams ``A (T, N)`` and ``B (T, M)`` (entries 0, +-1; T = samples x BL)

    count_up = (|B|^T |A| + B^T A) / 2 ,  count_dn = (|B|^T |A| - B^T A) / 2

are exact integers in float32, so any blocking of the contraction gives the
same counts; :func:`finalize_counts` (device maps, cycle-to-cycle noise,
per-device bound clip) is the one inexact step, shared by every update path.

Streams come from the counter hash (``utils/fastrng.py``): the element of
row ``r``, slot ``s`` and driver ``j`` draws ``uniform24(mix(e ^ mix(seed)))``
at ``e = ((row_offset + r) * BL + s) * n + j`` (u32), the JAX package's
layout.  Under ``cfg.use_pallas`` the counts go through the pulse-count
kernel (``kernels/pulse_update.py``); the fused backward+update kernel
regenerates the same streams on the card.  A tile with a sub-tile grid
(``cfg.tile_grid``) updates through ``core/tile_grid.py``.

Streaming: with ``cfg.update_chunk`` the flattened batch is walked in
chunks of that many rows, and the conv cycles walk their position columns
in chunks (:func:`pulse_update_streamed`).  A chunk's streams are its rows'
draws at ``row_offset=start``, and its counts add to the chunks' before it
(one pulse-count launch per chunk, accumulating into the first chunk's
outputs), so only one chunk's ``(rows, BL, n)`` streams are ever live and
the counts, hence the updated weights, are the materialized cycle's bits.
The chunk loops are host loops with host-int offsets: a captured step
records one launch per chunk.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import management
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor
_M32 = 0xFFFFFFFF


def pulse_probabilities(v: Tensor, gain: Tensor) -> Tuple[Tensor, Tensor]:
    """Firing probability and polarity per driver."""
    return torch.clamp(torch.abs(gain * v), 0.0, 1.0), torch.sign(v)


def signed_streams(seed: fastrng.Seed, v: Tensor, gain: Tensor, bl: int, *,
                   row_offset: Optional[int] = None) -> Tensor:
    """Signed pulse streams ``(..., BL, n)`` of the drivers ``v (..., n)``
    from the u32 ``seed`` word (an int, or a 0-d int64 tensor on ``v``'s
    device); ``row_offset`` shifts the counters by that many rows of a
    larger logical batch."""
    p, sgn = pulse_probabilities(v, gain)
    n = v.shape[-1]
    shape = (*v.shape[:-1], bl, n)
    off = None if row_offset is None else (int(row_offset) * bl * n) & _M32
    u = fastrng.uniform24(fastrng.bits_from_seed(seed, shape, off,
                                                 device=v.device))
    fire = (u < p[..., None, :]).to(v.dtype)
    return fire * sgn[..., None, :]


def sample_signed_streams(key: prng.Key, v: Tensor, gain: Tensor, bl: int,
                          fast_rng: bool = True, *,
                          row_offset: Optional[int] = None) -> Tensor:
    """Signed pulse streams drawn from ``key`` (the counter-hash RNG)."""
    if not fast_rng:
        raise NotImplementedError(
            "only the counter-hash pulse streams (fast_rng=True) are ported")
    return signed_streams(fastrng.key_to_seed(key), v, gain, bl,
                          row_offset=row_offset)


def coincidence_counts(streams_rows: Tensor, streams_cols: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Up/down coincidence counts ``(M, N)`` of signed streams
    ``(..., BL, M)`` and ``(..., BL, N)``, contracting all leading axes."""
    from repro_torch.kernels.pulse_update import pulse_counts_plain
    m = streams_rows.shape[-1]
    n = streams_cols.shape[-1]
    return pulse_counts_plain(streams_rows.reshape(-1, m),
                              streams_cols.reshape(-1, n))


def counts_to_dw(count_up: Tensor, count_dn: Tensor, dw_up: Tensor,
                 dw_dn: Tensor, seed: fastrng.Seed, ctoc: float) -> Tensor:
    """Physical ``DW`` from the counts under the maps ``dw_up``, ``dw_dn``,
    plus cycle-to-cycle variation ``ctoc sqrt(up dw_up^2 + dn dw_dn^2) xi``
    with ``xi`` the counter-hash normal of the u32 ``seed`` at the flat
    index ``row * N + col`` — the fused update kernel's finalize."""
    xi = None
    if ctoc > 0.0:
        n = count_up.numel()
        e = torch.arange(n, dtype=torch.int64,
                         device=count_up.device).reshape(count_up.shape)
        xi = fastrng.normal_at(fastrng.mix_seed(seed), e, n)
    return maps_dw(count_up, count_dn, dw_up, dw_dn, ctoc, xi)


def maps_dw(count_up: Tensor, count_dn: Tensor, dw_up: Tensor,
            dw_dn: Tensor, ctoc: float, xi: Optional[Tensor]) -> Tensor:
    """``count_up dw_up - count_dn dw_dn``, plus ``ctoc sqrt(up dw_up^2 +
    dn dw_dn^2) xi`` for the standard normals ``xi`` when ``ctoc > 0``."""
    dw = count_up * dw_up - count_dn * dw_dn
    if ctoc > 0.0:
        var = count_up * dw_up ** 2 + count_dn * dw_dn ** 2
        dw = dw + ctoc * torch.sqrt(var) * xi
    return dw


def dw_from_counts(count_up: Tensor, count_dn: Tensor, maps: DeviceMaps,
                   k_c: prng.Key, cfg: RPUConfig) -> Tensor:
    """Physical ``DW`` from the counts: device maps plus cycle-to-cycle
    variation (one ``(M, N)`` counter-hash normal draw from ``k_c``)."""
    if cfg.dw_min_ctoc > 0.0 and not cfg.fast_rng:
        raise NotImplementedError(
            "only the counter-hash ctoc noise (fast_rng=True) is ported")
    return counts_to_dw(count_up, count_dn, maps.dw_up, maps.dw_dn,
                        fastrng.key_to_seed(k_c),
                        cfg.dw_min_ctoc).to(cfg.dtype)


def finalize_counts(w: Tensor, maps: DeviceMaps, count_up: Tensor,
                    count_dn: Tensor, k_c: prng.Key, cfg: RPUConfig
                    ) -> Tensor:
    """One update cycle's counts applied to the physical weights: maps,
    ctoc noise and the per-device bound clip."""
    dw = dw_from_counts(count_up, count_dn, maps, k_c, cfg)
    return torch.clamp(w + dw, -maps.bound, maps.bound)


Counts = Tuple[Tensor, Tensor]


def stream_counts(x: Tensor, delta: Tensor, cx: Tensor, cd: Tensor,
                  k_a: prng.Key, k_b: prng.Key, cfg: RPUConfig, *,
                  row_offset: Optional[int] = None,
                  out: Optional[Counts] = None) -> Counts:
    """Counts of (column, row) driver pairs: streams sampled here (at the
    counters of rows ``row_offset`` on), counted by the pulse-count kernel
    under ``cfg.use_pallas`` (else the plain two-product version); with
    ``out``, added to those counts in place."""
    a = sample_signed_streams(k_a, x, cx, cfg.bl, cfg.fast_rng,
                              row_offset=row_offset)
    b = sample_signed_streams(k_b, delta, cd, cfg.bl, cfg.fast_rng,
                              row_offset=row_offset)
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.pulse_counts(b, a, out)
    up, dn = coincidence_counts(b, a)
    if out is None:
        return up, dn
    return out[0].add_(up), out[1].add_(dn)


def chunk_starts(total: int, chunk: int):
    """``(start, rows)`` of each chunk of ``total`` rows; the last chunk
    holds what is left (its missing rows would fire no pulse and read
    nothing that is kept)."""
    return [(s, min(chunk, total - s)) for s in range(0, total, chunk)]


#: ``get_chunk(src, start, rows) -> (cols, delta_phys)``: rows ``[start,
#: start + rows)`` of the column drivers and the replicated error rows.
GetChunk = Callable[[object, int, int], Tuple[Tensor, Tensor]]


def row_slices(src, start: int, rows: int) -> Tuple[Tensor, Tensor]:
    """The :data:`GetChunk` of materialized drivers ``src = (x2, d2)``."""
    return src[0][start:start + rows], src[1][start:start + rows]


def accumulate_counts(src, get_chunk: GetChunk, total: int, chunk: int,
                      cx: Tensor, cd: Tensor, k_a: prng.Key, k_b: prng.Key,
                      cfg: RPUConfig) -> Counts:
    """Coincidence counts of ``total`` driver rows, ``chunk`` at a time:
    each chunk's streams drawn at its rows' counters and counted into the
    first chunk's outputs (exact: integers)."""
    acc = None
    for start, n in chunk_starts(total, chunk):
        cols, delta = get_chunk(src, start, n)
        acc = stream_counts(cols, delta, cx, cd, k_a, k_b, cfg,
                            row_offset=start, out=acc)
    return acc


def _chunked_counts(x2: Tensor, d2: Tensor, cx: Tensor, cd: Tensor,
                    k_a: prng.Key, k_b: prng.Key, cfg: RPUConfig,
                    chunk: int) -> Counts:
    """Coincidence counts over row chunks of the flattened (samples x
    positions) contraction axis: only ``chunk`` rows of signed streams are
    live at a time."""
    return accumulate_counts((x2, d2), row_slices, x2.shape[0], chunk, cx,
                             cd, k_a, k_b, cfg)


def pulse_update(w: Tensor, maps: DeviceMaps, x: Tensor, delta: Tensor,
                 key: prng.Key, cfg: RPUConfig, lr: float) -> Tensor:
    """Full update cycle on the physical weights.  ``delta`` is the logical
    error ``(..., out_f)``; it is replicated to the #_d physical row blocks
    here (independent streams per physical row driver).  With
    ``cfg.update_chunk`` below the number of vector pairs, the counts
    accumulate over chunks of them (:func:`_chunked_counts`); maps, ctoc
    noise and the clip apply once, as in the materialized cycle."""
    from repro_torch.core.tile import _grid_routed, replicate_delta
    delta = replicate_delta(delta, cfg.devices_per_weight,
                            rows_phys=w.shape[0])
    if _grid_routed(cfg):
        from repro_torch.core import tile_grid
        return tile_grid.grid_pulse_update(w, maps, x, delta, key, cfg, lr)
    if x.dim() == 1:
        x, delta = x[None], delta[None]
    k_a, k_b, k_c = prng.split(key, 3)
    cx, cd = management.um_factors(x, delta, cfg, lr)
    t = x.numel() // x.shape[-1]
    if cfg.update_chunk is not None and cfg.update_chunk < t:
        count_up, count_dn = _chunked_counts(
            x.reshape(t, x.shape[-1]), delta.reshape(t, delta.shape[-1]),
            cx, cd, k_a, k_b, cfg, cfg.update_chunk)
    else:
        count_up, count_dn = stream_counts(x, delta, cx, cd, k_a, k_b, cfg)
    return finalize_counts(w, maps, count_up, count_dn, k_c, cfg)


def um_from_maxima(um_maxima, cfg: RPUConfig, lr: float, device):
    """Pulse gains from precomputed ``(max|x|, max|d|)`` extrema, which
    update management over never-materialized columns requires."""
    if um_maxima is None:
        if cfg.update_management:
            raise ValueError("update management over streamed chunks needs "
                             "the precomputed (x_max, d_max) extrema")
        return management.um_factors_from_max(None, None, cfg, lr,
                                              device=device)
    return management.um_factors_from_max(*um_maxima, cfg, lr)


def pulse_update_streamed(w: Tensor, maps: DeviceMaps, src,
                          get_chunk: GetChunk, key: prng.Key, cfg: RPUConfig,
                          lr: float, *, total: int, chunk: int,
                          um_maxima=None) -> Tensor:
    """Update cycle over generated chunks: the streaming conv entry
    (``core/conv_mapping.py``).  ``get_chunk(src, start, rows)`` makes one
    chunk of im2col columns and the matching replicated error rows (the
    last chunk holds ``total - start`` rows), so neither the whole column
    matrix nor its streams exist at once.  ``um_maxima``: the precomputed
    ``(max|x|, max|d|)`` (the window max of the activation volume),
    required under update management.  The counts of every chunk add up,
    then maps, ctoc noise and the clip apply once: the bits of
    :func:`pulse_update` over the materialized columns."""
    from repro_torch.core.tile import _grid_routed
    if _grid_routed(cfg):
        from repro_torch.core import tile_grid
        return tile_grid.grid_pulse_update_streamed(
            w, maps, src, get_chunk, key, cfg, lr, total=total, chunk=chunk,
            um_maxima=um_maxima)
    k_a, k_b, k_c = prng.split(key, 3)
    cx, cd = um_from_maxima(um_maxima, cfg, lr, w.device)
    count_up, count_dn = accumulate_counts(src, get_chunk, total, chunk, cx,
                                           cd, k_a, k_b, cfg)
    return finalize_counts(w, maps, count_up, count_dn, k_c, cfg)
