"""Tile-API wrappers around the read kernels.

These adapt the config-carrying, arbitrary-batch-shape tile API onto the
2-D kernel interfaces and keep the JAX package's key -> seed discipline: a
two-phase managed read consumes ``split(key)`` (one seed per read), a
single read consumes ``key`` itself (the same seed twice).  Seeds are
derived on the host and passed to the kernels by value.

Every launch carries a stable kind name (``noisy_read``, ``managed_read``)
that names its ``torch.profiler`` range; :func:`launch_counts` reads the
kernel wrappers' launch counters per kind.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.device import RPUConfig
from repro_torch.kernels import managed_mvm as _managed
from repro_torch.kernels import noisy_mvm as _noisy
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kind since the last :func:`reset_launch_counts`."""
    return {"noisy_read": _noisy.launches, "managed_read": _managed.launches}


def reset_launch_counts() -> None:
    _noisy.launches = 0
    _managed.launches = 0


def _n_seg(w: Tensor, cfg: RPUConfig, transpose: bool) -> int:
    r, c = w.shape
    contraction = r if transpose else c
    limit = cfg.max_array_rows if transpose else cfg.max_array_cols
    return max(1, -(-contraction // limit))


def _sigma(cfg: RPUConfig, transpose: bool) -> float:
    on = cfg.noise_backward if transpose else cfg.noise_forward
    return float(cfg.read_noise) if on else 0.0


def noisy_mvm(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
              transpose: bool = False, row_offset: Optional[int] = None,
              total_rows: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Kernel-backed raw analog read with the tile API contract (arbitrary
    leading batch dims; per-vector saturation flag)."""
    r, c = w.shape
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    with torch.profiler.record_function("noisy_read"):
        y2d, sat = _noisy.noisy_mvm(
            w, x2d, fastrng.key_to_seed(key), sigma=_sigma(cfg, transpose),
            alpha=float(cfg.out_bound), n_seg=_n_seg(w, cfg, transpose),
            transpose=transpose, row_offset=row_offset,
            total_rows=total_rows)
    out_dim = c if transpose else r
    return y2d.reshape(*batch_shape, out_dim), sat.reshape(batch_shape)


def managed_mvm(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
                transpose: bool = False, backward: bool = False,
                row_offset: Optional[int] = None,
                total_rows: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Kernel-backed managed read: NM scale, fixed-latency BM (off or
    two-phase), clipping and the #_d replica average.  Iterative BM is
    data-dependent and goes through ``management.with_bound_management``
    over :func:`noisy_mvm` instead."""
    from repro_torch.core import management

    r, c = w.shape
    d_avg = 1 if transpose else cfg.devices_per_weight
    use_bm = cfg.bound_management and cfg.out_bound != float("inf")
    if use_bm and cfg.bm_mode != "two_phase":
        raise ValueError(
            "iterative BM cannot be fused into one read; use "
            "management.with_bound_management over noisy_mvm")
    use_nm = cfg.noise_management and (backward or cfg.nm_forward)

    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    nm_s = (management.nm_scale(x2d) if use_nm
            else torch.ones(x2d.shape[0], 1, dtype=x2d.dtype,
                            device=x2d.device))
    if use_bm:
        k1, k2 = prng.split(key)
        seeds = (fastrng.key_to_seed(k1), fastrng.key_to_seed(k2))
    else:
        s1 = fastrng.key_to_seed(key)
        seeds = (s1, s1)
    with torch.profiler.record_function("managed_read"):
        y2d, sat = _managed.managed_mvm(
            w, x2d, nm_s, seeds, sigma=_sigma(cfg, transpose),
            alpha=float(cfg.out_bound), n_seg=_n_seg(w, cfg, transpose),
            transpose=transpose, two_phase=use_bm,
            retry_scale=float(management.TWO_PHASE_SCALE), d_avg=d_avg,
            row_offset=row_offset, total_rows=total_rows)
    out_f = c if transpose else r // d_avg
    return y2d.reshape(*batch_shape, out_f), sat.reshape(batch_shape)
