"""AnalogTile: the physical RPU crossbar read (forward cycle).

A tile holds the physical weights ``(#_d * out_f, in_f)`` of one logical
matrix.  Every read draws fresh Gaussian noise (sigma) and clips at the
integrator bound (+-alpha); contractions longer than the physical array
(4096, paper Discussion) split into segments, each an independent physical
read whose noise and bound apply before the digital sum.

``cfg.use_pallas`` routes the reads through the CUDA kernels
(``repro_torch.kernels``); otherwise the plain-PyTorch reference below runs
(it is also the kernels' oracle).  The sharded tile grid
(``cfg.tile_grid``) is not part of this package yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import management
from repro_torch.core.device import RPUConfig
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor


def _num_splits(contraction_dim: int, limit: int) -> int:
    return max(1, -(-contraction_dim // limit))


def _check_supported(cfg: RPUConfig) -> None:
    if cfg.tile_grid is not None and tuple(cfg.tile_grid) != (1, 1):
        raise NotImplementedError("tile grids are not ported yet")


def analog_mvm(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
               transpose: bool = False, row_offset: Optional[int] = None,
               total_rows: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """One physical array read ``y = clip(W x + sigma*xi, +-alpha)`` with
    contraction splits; returns ``(y, sat)`` with a per-vector flag."""
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.noisy_mvm(w, x, key, cfg, transpose=transpose,
                              row_offset=row_offset, total_rows=total_rows)
    return analog_mvm_reference(w, x, key, cfg, transpose=transpose,
                                row_offset=row_offset, total_rows=total_rows)


def analog_mvm_reference(w: Tensor, x: Tensor, key: prng.Key,
                         cfg: RPUConfig, *, transpose: bool = False,
                         row_offset: Optional[int] = None,
                         total_rows: Optional[int] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Plain-PyTorch analog read: the counter-hash noise of
    ``fastrng.normal`` at flat counter ``(b * n_seg + seg) * out + col``
    (shifted by ``row_offset`` rows), segment reads clipped before the
    digital sum."""
    from repro_torch.kernels.noisy_mvm import noisy_mvm_plain

    if not cfg.fast_rng:
        raise NotImplementedError(
            "only the counter-hash read noise (fast_rng=True) is ported")
    r, c = w.shape
    contraction, limit = ((r, cfg.max_array_rows) if transpose
                          else (c, cfg.max_array_cols))
    if x.shape[-1] != contraction:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)} (transpose={transpose})")
    sigma = cfg.read_noise if (cfg.noise_backward if transpose
                               else cfg.noise_forward) else 0.0
    batch_shape = x.shape[:-1]
    y, sat = noisy_mvm_plain(
        w, x.reshape(-1, contraction), fastrng.key_to_seed(key),
        sigma=float(sigma), alpha=float(cfg.out_bound),
        n_seg=_num_splits(contraction, limit), transpose=transpose,
        row_offset=row_offset, total_rows=total_rows)
    return y.reshape(*batch_shape, y.shape[-1]), sat.reshape(batch_shape)


def _bm_is_iterative(cfg: RPUConfig) -> bool:
    """True when BM runs the data-dependent halve-and-retry loop."""
    return (cfg.bound_management and cfg.out_bound != float("inf")
            and cfg.bm_mode != "two_phase")


def managed_mvm_reference(w: Tensor, x: Tensor, key: prng.Key,
                          cfg: RPUConfig, *, transpose: bool = False,
                          backward: bool = False,
                          row_offset: Optional[int] = None,
                          total_rows: Optional[int] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain managed read: NM scale (once) + BM over raw reference reads,
    on physical output channels (the #_d average is the caller's step)."""
    def mvm(xx, kk):
        return analog_mvm_reference(w, xx, kk, cfg, transpose=transpose,
                                    row_offset=row_offset,
                                    total_rows=total_rows)

    return management.with_management(mvm, x, key, cfg, backward=backward)


def _replica_mean(y_phys: Tensor, d: int) -> Tensor:
    if d == 1:
        return y_phys
    out_f = y_phys.shape[-1] // d
    return torch.mean(y_phys.reshape(*y_phys.shape[:-1], d, out_f), dim=-2)


def tile_forward(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
                 return_sat: bool = False, row_offset: Optional[int] = None,
                 total_rows: Optional[int] = None):
    """Forward cycle ``y = W_eff x`` with NM/BM management + replica average.

    With ``cfg.use_pallas`` and a fixed-latency BM mode (off or two-phase)
    the whole managed read is the ``managed_mvm`` kernel; iterative BM runs
    its retry loop over one ``noisy_mvm`` kernel launch per read.
    """
    _check_supported(cfg)
    if cfg.use_pallas and not _bm_is_iterative(cfg):
        from repro_torch.kernels import ops as kops
        y, sat = kops.managed_mvm(w, x, key, cfg, transpose=False,
                                  backward=False, row_offset=row_offset,
                                  total_rows=total_rows)
        return (y, sat) if return_sat else y

    def mvm(xx, kk):
        return analog_mvm(w, xx, kk, cfg, transpose=False,
                          row_offset=row_offset, total_rows=total_rows)

    y_phys, sat = management.with_management(mvm, x, key, cfg,
                                             backward=False)
    y = _replica_mean(y_phys, cfg.devices_per_weight)
    return (y, sat) if return_sat else y
