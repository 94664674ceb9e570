"""Analog fully-connected layer: the forward cycle ``y = f_mgmt(W x)``.

Biases live on the array as an extra always-on input column (the paper's
K1 layout).  ``mode='digital'`` computes an exact FP dense layer over the
effective (replica-averaged) weights.

Only the forward (inference) cycle is ported: the backward read and the
stochastic-pulse update, and with them autograd, are not part of this
package yet.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.core import tile as tile_lib
from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor


def _split3(key: prng.Key) -> List[prng.Key]:
    """Forward / backward / update keys of one layer application."""
    return prng.split(key, 3)


def _forward_key(key: prng.Key) -> prng.Key:
    """``_split3(key)[0]`` without drawing the other two keys (in threefry's
    partitionable mode ``split(key, n)[i]`` does not depend on ``n``)."""
    return prng.split(key, 1)[0]


def effective_weights(w: Tensor, cfg: RPUConfig) -> Tensor:
    """Logical weights: digital mean over the #_d physical replicas."""
    d = cfg.devices_per_weight
    if d == 1:
        return w
    return torch.mean(w.reshape(d, w.shape[0] // d, w.shape[1]), dim=0)


def apply(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
          bias: bool = True, mode: str = "analog") -> Tensor:
    """Apply the layer to ``x`` (..., in_f).  ``mode``: 'analog' (RPU
    physics) or 'digital' (FP)."""
    if bias:
        ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
        x = torch.cat([x, ones], dim=-1)
    if mode == "digital":
        return torch.einsum("...k,ok->...o", x,
                            effective_weights(w, cfg).to(x.dtype))
    return tile_lib.tile_forward(w, x, _forward_key(key), cfg)
