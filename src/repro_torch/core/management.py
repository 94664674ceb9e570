"""Noise management (NM, Eq. 3) and bound management (BM, Eq. 4): digital
rescalings around the raw analog read.

NM and BM compose as one per-vector digital scale ``s = s_nm * 2^n``
threaded through the raw read ``analog_mvm(x, key) -> (y, sat)``::

    y = [ W (x / s) + sigma ] * s

``s_nm = max|x|`` is computed once from the unscaled input.  The key
schedule is the JAX package's exactly: iterative BM splits once for the
first read, then once per retry; two-phase BM splits the key into the keys
of its two reads.

Iterative BM has two forms with the same numbers.  Under a host key
(``prng.Key``: the per-step loop, serving) it is a Python loop whose every
retry decision reads the saturation flags back to the host.  Under a key of
a key tape (``prng.DeviceKey``: the epoch engine's captured step) it is
:func:`with_bound_management_predicated`: all ``bm_max_iters`` retries are
unrolled, and each runs on a device predicate, so no retry decision leaves
the card and one CUDA graph holds the whole loop.

The raw read may be a whole sub-tile grid's (``core/tile_grid.py``): its
flag is the OR over the blocks, so every retry re-reads every block at the
same scale, and a predicated retry's ``go`` reaches every block's launch.

Update management (UM) returns the pulse gains ``(C_x, C_d)`` as 0-d
float32 tensors on the data's device, so the update cycle never reads a
device maximum back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor
AnalogMVM = Callable[..., Tuple[Tensor, Tensor]]

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
    if _retry_counter is not None:
        _retry_counter.add_(n_iter)
    return y, sat


#: Device counter of the retries iterative BM ran (None: not counted).
#: Only a check sets it (:class:`count_retries`); the predicated form then
#: adds each retry's predicate, one more kernel per retry.
_retry_counter: Optional[Tensor] = None


class count_retries:
    """``with count_retries(device) as n:`` adds the retries of every
    iterative-BM read made (or captured) inside the block, in either form,
    to the int64 device scalar ``n``.  A graph captured inside the block
    goes on adding on each replay: ``n`` must outlive it."""

    def __init__(self, device):
        self.n = torch.zeros((), dtype=torch.int64, device=device)

    def __enter__(self) -> Tensor:
        global _retry_counter
        self._prev, _retry_counter = _retry_counter, self.n
        return self.n

    def __exit__(self, *exc) -> None:
        global _retry_counter
        _retry_counter = self._prev


def with_bound_management_predicated(analog_mvm: AnalogMVM, x: Tensor,
                                     key: prng.AnyKey, max_iters: int, *,
                                     init_scale: Optional[Tensor] = None
                                     ) -> Tuple[Tensor, Tensor]:
    """:func:`with_bound_management` with no host synchronisation: the
    ``max_iters`` retries are unrolled, retry ``i`` runs on the device
    predicate ``go_i = go_{i-1} and any(sat_{i-1})`` (a 0-d bool tensor),
    which the raw read takes as ``analog_mvm(x, key, go=go)`` (it returns
    at once when ``go`` is false), and ``torch.where(go, ...)`` keeps the last
    read's ``(y * scale, sat)`` and scale.  Every retry's key is split as
    the loop splits it, so the keys the reads use are the loop's, and the
    result is the loop's bit for bit."""
    scale = _vector_scale(x, init_scale)
    key, k0 = prng.split(key)
    y, sat = analog_mvm(x / scale[..., None], k0)
    y = y * scale[..., None]
    go = None
    for _ in range(max_iters):
        key, k_read = prng.split(key)
        go = torch.any(sat) if go is None else go & torch.any(sat)
        s = torch.where(sat, scale * 2.0, scale)
        y_r, sat_r = analog_mvm(x / s[..., None], k_read, go=go)
        y = torch.where(go, y_r * s[..., None], y)
        sat = torch.where(go, sat_r, sat)
        scale = torch.where(go, s, scale)
        if _retry_counter is not None:
            _retry_counter.add_(go.long())
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


def bounded(cfg: RPUConfig) -> bool:
    """True when BM is on and the output bound is finite."""
    return cfg.bound_management and cfg.out_bound != float("inf")


def bm_is_iterative(cfg: RPUConfig) -> bool:
    """True when BM runs the data-dependent halve-and-retry loop, which no
    single kernel launch can hold (off and two-phase are fixed-latency)."""
    return bounded(cfg) and cfg.bm_mode != "two_phase"


def with_management(analog_mvm: AnalogMVM, x: Tensor, key: prng.Key,
                    cfg: RPUConfig, *, backward: bool
                    ) -> Tuple[Tensor, Tensor]:
    """Compose NM and BM around one managed read per the config flags;
    ``analog_mvm`` must be the raw physical read (taking ``go=`` under a
    key tape's key and iterative BM)."""
    use_nm = cfg.noise_management and (backward or cfg.nm_forward)
    s_nm = nm_scale(x) if use_nm else None

    if bounded(cfg):
        if not bm_is_iterative(cfg):
            return with_bound_management_two_phase(
                analog_mvm, x, key, init_scale=s_nm)
        bm = (with_bound_management_predicated
              if isinstance(key, prng.DeviceKey) else with_bound_management)
        return bm(analog_mvm, x, key, cfg.bm_max_iters, init_scale=s_nm)

    if use_nm:
        y, sat = analog_mvm(x / s_nm, key)
        return y * s_nm, sat
    return analog_mvm(x, key)


# ---------------------------------------------------------------------------
# Update management
# ---------------------------------------------------------------------------

def amplification_factors(cfg: RPUConfig, lr: float) -> np.float32:
    """Base amplification ``C = sqrt(eta / (BL * dw_min))`` shared by rows
    and columns, in float32 arithmetic (the layers hold ``eta`` as a float32
    scalar, as the JAX package's layers do)."""
    ratio = np.float32(lr) / np.float32(cfg.bl * cfg.dw_min)
    return np.sqrt(ratio, dtype=np.float32)


def um_factors_from_max(x_max: Optional[Tensor], d_max: Optional[Tensor],
                        cfg: RPUConfig, lr: float, *, device=None
                        ) -> Tuple[Tensor, Tensor]:
    """Pulse gains from the scalar extrema ``max|x|`` and ``max|d|`` (0-d
    tensors; unused without UM, when ``device`` places the constants)."""
    c = float(amplification_factors(cfg, lr))
    if not cfg.update_management:
        dev = device if x_max is None else x_max.device
        # a fill, not a copy from the host: capturable in a CUDA graph
        t = torch.full((), c, dtype=cfg.dtype, device=dev)
        return t, t
    x_max = torch.clamp_min(x_max, _EPS)
    d_max = torch.clamp_min(d_max, _EPS)
    m = torch.clamp(torch.sqrt(d_max / x_max), 1e-3, 1e3)
    # a float / tensor would be a reciprocal times c in torch: divide a
    # tensor so it rounds like the true division
    return (m * c).to(cfg.dtype), torch.div(torch.full_like(m, c), m).to(
        cfg.dtype)


def um_factors(x: Tensor, d: Tensor, cfg: RPUConfig, lr: float
               ) -> Tuple[Tensor, Tensor]:
    """Update-management pulse gains over every axis of the activations
    ``x`` and errors ``d`` (``C_x = C_d = C`` without UM; with UM
    ``m = sqrt(max|d| / max|x|)``, ``C_x = m C``, ``C_d = C / m``)."""
    if not cfg.update_management:
        return um_factors_from_max(None, None, cfg, lr, device=x.device)
    return um_factors_from_max(torch.amax(torch.abs(x)),
                               torch.amax(torch.abs(d)), cfg, lr)
