"""Fully unrolled reference for the analog recurrent cell.

Port of the JAX package's ``recurrent/oracle.py``: the *oracle* side of
the temporal-reuse parity contract.  A plain Python loop with no count
accumulation and no fused launch:

* forward: one managed ``tile_forward`` read per gate tile per timestep
  (the cell's ``fold_in(key, t)`` read-key schedule);
* backward: one managed ``tile_backward`` transpose read per timestep,
  chaining BPTT through the shared digital gate backward;
* update: every timestep's (driver, error) pair is **materialized and
  stacked timestep-major**, then ``update.pulse_update`` runs ONCE per
  tile over the whole (T*B)-row batch: the single-shot cycle whose pulse
  streams the cell's per-timestep ``row_offset = t * B`` blocks must slice
  bit for bit.

``cell.cell_apply``'s backward must give every output of
:func:`unrolled_reference` bit for bit, for any ``time_chunk`` and on both
the separate and the fused (``cfg.fuse_bwd_update``) route.  The device
maps are regenerated from the tile seeds, as the JAX oracle does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import RPUConfig, sample_device_maps
from repro_torch.recurrent.cell import (CellSpec, _augment, _nonlin_bwd,
                                        _nonlin_fwd, _split3)
from repro_torch.utils import prng

Tensor = torch.Tensor


def unrolled_reference(spec: CellSpec, cfg: RPUConfig, wx: Tensor,
                       sx: prng.Key, wh: Tensor, sh: prng.Key, xs: Tensor,
                       h0: Tensor, c0: Tensor, key: prng.Key, lr: float,
                       g_hs: Tensor, g_ht: Optional[Tensor] = None,
                       g_ct: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Unrolled forward + BPTT + single-shot update for one training step.

    Returns ``hs/h_t/c_t`` (forward), ``dxs/dh0/dc0`` (input cotangents)
    and ``wx_bar/wh_bar`` (the ``W - clip(W + DW_pulse)`` weight
    cotangents), all bit-comparable to the cell's autograd.
    """
    t_total = xs.shape[0]
    k_f, k_b, k_u = _split3(key)
    k_fx, k_fh = prng.split(k_f)
    k_bx, k_bh = prng.split(k_b)
    k_ux, k_uh = prng.split(k_u)

    # ---- forward: T managed reads per tile --------------------------------
    h, c = h0, c0
    hs, res = [], []
    for t in range(t_total):
        xa = _augment(spec, xs[t])
        ax = tile_lib.tile_forward(wx, xa, prng.fold_in(k_fx, t), cfg)
        bh = tile_lib.tile_forward(wh, h, prng.fold_in(k_fh, t), cfg)
        h2, c2 = _nonlin_fwd(spec, ax, bh, h, c)
        res.append((ax, bh, h, c, xa))
        hs.append(h2)
        h, c = h2, c2

    # ---- BPTT: T transpose reads per tile, pairs materialized -------------
    dh = torch.zeros_like(h) if g_ht is None else g_ht
    dc = torch.zeros_like(c) if g_ct is None else g_ct
    dxs = [None] * t_total
    pairs_x, pairs_h = [None] * t_total, [None] * t_total
    for t in reversed(range(t_total)):
        ax, bh, hp, cp, xa = res[t]
        dh = dh + g_hs[t]
        delta_x, delta_h, dh_loc, dc_prev = _nonlin_bwd(
            spec, ax, bh, hp, cp, dh, dc)
        zx = tile_lib.tile_backward(wx, delta_x, prng.fold_in(k_bx, t), cfg)
        zh = tile_lib.tile_backward(wh, delta_h, prng.fold_in(k_bh, t), cfg)
        dh, dc = dh_loc + zh, dc_prev
        pairs_x[t] = (xa, delta_x)
        pairs_h[t] = (hp, delta_h)
        dxs[t] = zx[..., :xs.shape[-1]]

    # ---- update: ONE single-shot pulse cycle per tile ---------------------
    def update(w, seed, pairs, k):
        maps = sample_device_maps(seed, w.shape[0], w.shape[1], cfg,
                                  device=w.device)
        drv = torch.stack([p[0] for p in pairs])          # (T, B, n)
        err = torch.stack([p[1] for p in pairs])          # (T, B, G*H)
        return w - update_lib.pulse_update(w, maps, drv, -err, k, cfg, lr)

    return {
        "hs": torch.stack(hs), "h_t": h, "c_t": c,
        "dxs": torch.stack(dxs), "dh0": dh, "dc0": dc,
        "wx_bar": update(wx, sx, pairs_x, k_ux),
        "wh_bar": update(wh, sh, pairs_h, k_uh),
    }
