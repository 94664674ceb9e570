"""Noise management (NM, Eq. 3) and bound management (BM, Eq. 4): digital
rescalings around the raw analog read.

NM and BM compose as one per-vector digital scale ``s = s_nm * 2^n``
threaded through the raw read ``analog_mvm(x, key) -> (y, sat)``::

    y = [ W (x / s) + sigma ] * s

``s_nm = max|x|`` is computed once from the unscaled input.  The key
schedule is the JAX package's exactly: iterative BM splits once for the
first read, then once per retry; two-phase BM splits the key into the keys
of its two reads.

Iterative BM's data-dependent loop is a Python loop here: each retry
decision reads the saturation flags back to the host (one ``.item()``
synchronisation per check).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor
AnalogMVM = Callable[[Tensor, prng.Key], Tuple[Tensor, Tensor]]

_EPS = 1e-12

#: Input down-scale of the second (unconditional) two-phase BM read.
TWO_PHASE_SCALE = 16.0


def nm_scale(x: Tensor) -> Tensor:
    """Per-vector NM scale max|x| over the fan-in axis, ``(..., 1)``; zero
    vectors get scale 1."""
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.where(s > _EPS, s, torch.ones_like(s))


def _vector_scale(x: Tensor, init_scale: Optional[Tensor]) -> Tensor:
    """Initial per-vector digital scale, shape ``x.shape[:-1]``."""
    if init_scale is None:
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return init_scale.reshape(*x.shape[:-1], -1)[..., 0].to(x.dtype)


def with_bound_management(analog_mvm: AnalogMVM, x: Tensor, key: prng.Key,
                          max_iters: int, *,
                          init_scale: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Iterative halve-and-retry BM: re-read every vector with its scale
    doubled where it saturated, until no vector saturates or ``max_iters``
    retries ran.  Returns ``(y, residual_sat)``."""
    scale = _vector_scale(x, init_scale)
    key, k0 = prng.split(key)
    y, sat = analog_mvm(x / scale[..., None], k0)
    y = y * scale[..., None]
    n_iter = 0
    while n_iter < max_iters and bool(sat.any().item()):
        key, k_read = prng.split(key)
        scale = torch.where(sat, scale * 2.0, scale)
        y, sat = analog_mvm(x / scale[..., None], k_read)
        y = y * scale[..., None]
        n_iter += 1
    return y, sat


def with_bound_management_two_phase(analog_mvm: AnalogMVM, x: Tensor,
                                    key: prng.Key, *,
                                    init_scale: Optional[Tensor] = None
                                    ) -> Tuple[Tensor, Tensor]:
    """Two-phase BM: one unconditional retry at 1/16 input scale, selected
    where the first read saturated.  Returns ``(y, sat1 & sat2)``."""
    s0 = _vector_scale(x, init_scale)[..., None]
    k1, k2 = prng.split(key)
    y1, sat1 = analog_mvm(x / s0, k1)
    y2, sat2 = analog_mvm(x / (TWO_PHASE_SCALE * s0), k2)
    y = torch.where(sat1[..., None], y2 * TWO_PHASE_SCALE, y1) * s0
    return y, sat1 & sat2


def with_management(analog_mvm: AnalogMVM, x: Tensor, key: prng.Key,
                    cfg: RPUConfig, *, backward: bool
                    ) -> Tuple[Tensor, Tensor]:
    """Compose NM and BM around one managed read per the config flags;
    ``analog_mvm`` must be the raw physical read."""
    use_nm = cfg.noise_management and (backward or cfg.nm_forward)
    s_nm = nm_scale(x) if use_nm else None

    if cfg.bound_management and cfg.out_bound != float("inf"):
        if cfg.bm_mode == "two_phase":
            return with_bound_management_two_phase(
                analog_mvm, x, key, init_scale=s_nm)
        return with_bound_management(
            analog_mvm, x, key, cfg.bm_max_iters, init_scale=s_nm)

    if use_nm:
        y, sat = analog_mvm(x / s_nm, key)
        return y * s_nm, sat
    return analog_mvm(x, key)
