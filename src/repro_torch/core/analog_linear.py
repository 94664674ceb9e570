"""Analog fully-connected layer with the RPU three-cycle backprop semantics.

The layer is an ordinary differentiable PyTorch function whose
``torch.autograd.Function`` implements the paper's physical cycles:

* forward  — managed analog read           ``y = f_mgmt(W x)``
* backward — managed analog transpose read ``x_bar = f_mgmt(W^T y_bar)``
* update   — the stochastic-pulse cycle, run inside the backward pass: the
  weight gradient is defined as ``w_bar := W - clip(W + DW_pulse)``, so the
  plain step ``w <- w - w_bar`` (``optim.analog_sgd``) lands the weights on
  the physically updated, bound-clipped value.  The pulse gains carry the
  learning rate (Eq. 1).

With ``cfg.fuse_bwd_update`` (and an eligible tile) the backward read and
the update are one kernel launch (``core.tile.tile_backward_update``).  With
``cfg.tile_grid`` the same cycles run on the tile's sub-tile grid
(``core/tile_grid.py``), which no fused kernel takes.

Biases live on the array as an extra always-on input column (the paper's K1
layout).  ``mode='digital'`` computes an exact FP dense layer over the
effective (replica-averaged) weights.  Without autograd (inference, or no
input that requires a gradient) the layer is the forward read alone.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor


def split3(key: prng.Key) -> List[prng.Key]:
    """Forward / backward / update keys of one layer application."""
    return prng.split(key, 3)


def forward_key(key: prng.Key) -> prng.Key:
    """``split3(key)[0]`` without drawing the other two keys (in threefry's
    partitionable mode ``split(key, n)[i]`` does not depend on ``n``)."""
    return prng.split(key, 1)[0]


def effective_weights(w: Tensor, cfg: RPUConfig) -> Tensor:
    """Logical weights: digital mean over the #_d physical replicas."""
    d = cfg.devices_per_weight
    if d == 1:
        return w
    return torch.mean(w.reshape(d, w.shape[0] // d, w.shape[1]), dim=0)


def backward_cycles(cfg: RPUConfig, w: Tensor, maps: DeviceMaps, x: Tensor,
                    g: Tensor, k_b: prng.Key, k_u: prng.Key, lr: float
                    ) -> Tuple[Tensor, Tensor]:
    """``(x_bar, w_bar)``: the transpose read of ``g`` under ``k_b`` and
    ``w - clip(w + DW_pulse(x, -g))`` under ``k_u`` — one fused launch when
    eligible, else the separate read and pulse update (same result)."""
    from repro_torch.kernels.bwd_update_mvm import bwd_update_eligible
    if bwd_update_eligible(cfg, w.shape):
        x_bar, new_w = tile_lib.tile_backward_update(w, maps, x, g, k_b, k_u,
                                                     cfg, lr)
    else:
        x_bar = tile_lib.tile_backward(w, g, k_b, cfg)
        new_w = update_lib.pulse_update(w, maps, x, -g, k_u, cfg, lr)
    return x_bar, w - new_w


class _AnalogCycles(torch.autograd.Function):
    """Forward read under ``k_f``; backward returns ``x_bar`` and ``w_bar``
    under ``k_b`` / ``k_u`` (the device maps stored, or regenerated from the
    tile seed when ``maps`` is None)."""

    @staticmethod
    def forward(ctx, cfg, w, x, key, lr, maps, seed):
        ctx.save_for_backward(w, x)
        ctx.cfg, ctx.key, ctx.lr, ctx.maps, ctx.seed = cfg, key, lr, maps, \
            seed
        return tile_lib.tile_forward(w, x, forward_key(key), cfg)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        _, k_b, k_u = split3(ctx.key)
        maps = tile_lib.tile_maps(w, ctx.maps, ctx.seed, ctx.cfg)
        x_bar, w_bar = backward_cycles(ctx.cfg, w, maps, x, g.contiguous(),
                                       k_b, k_u, ctx.lr)
        return None, w_bar, x_bar, None, None, None, None


def init(key: prng.Key, in_features: int, out_features: int, cfg: RPUConfig,
         bias: bool = True, init_scale: Optional[float] = None, *,
         device="cpu") -> Tuple[Tensor, Optional[DeviceMaps], prng.Key]:
    """A new analog linear tile ``(w, maps, seed)`` (bias = extra input
    column)."""
    cols = in_features + (1 if bias else 0)
    return tile_lib.init_tile(key, out_features, cols, cfg,
                              init_scale=init_scale, device=device)


def apply(w: Tensor, x: Tensor, key: Optional[prng.Key], cfg: RPUConfig,
          lr: float = 1.0, *, bias: bool = True, mode: str = "analog",
          maps: Optional[DeviceMaps] = None,
          seed: Optional[prng.Key] = None) -> Tensor:
    """Apply the layer to ``x`` (..., in_f).  ``mode``: 'analog' (RPU
    physics) or 'digital' (FP).  ``lr`` sets the pulse gains of the update
    cycle; ``maps``/``seed`` are the tile's device population (the update
    needs one of them)."""
    if bias:
        ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
        x = torch.cat([x, ones], dim=-1)
    if mode == "digital":
        return torch.einsum("...k,ok->...o", x,
                            effective_weights(w, cfg).to(x.dtype))
    if cfg.seeded_maps:
        maps = None
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _AnalogCycles.apply(cfg, w, x, key, float(lr), maps, seed)
    return tile_lib.tile_forward(w, x, forward_key(key), cfg)
