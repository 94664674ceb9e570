"""Tile-API wrappers around the read kernels.

These adapt the config-carrying, arbitrary-batch-shape tile API onto the
2-D kernel interfaces and keep the JAX package's key -> seed discipline: a
two-phase managed read consumes ``split(key)`` (one seed per read), a
single read consumes ``key`` itself (the same seed twice).  A host key's
seeds go to the kernels by value; a device key's (``prng.DeviceKey``) are
views of its key tape's seed table, read by the kernels from device memory.

Every launch carries a stable kind name (``noisy_read``, ``managed_read``,
``managed_read_conv``, ``pulse_counts``, ``pulse_update``, ``bwd_update``,
``bwd_update_conv``, ``flash_attention``; ``key_schedule`` for the step's
key tree, ``kernels/key_schedule.py``) that names its ``torch.profiler``
range; :func:`launch_counts` reads the kernel wrappers' launch counters per
kind.  A captured graph's replays add its launches to the same counters
(:func:`add_launch_counts`), since no wrapper runs then.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.kernels import bwd_update_mvm as _bwd
from repro_torch.kernels import conv_mvm as _conv
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import key_schedule as _keys
from repro_torch.kernels import managed_mvm as _managed
from repro_torch.kernels import noisy_mvm as _noisy
from repro_torch.kernels import pulse_update as _pulse
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor

# kind -> (wrapper module, name of its launch counter)
_COUNTERS = {
    "noisy_read": (_noisy, "launches"),
    "managed_read": (_managed, "launches"),
    "managed_read_conv": (_conv, "launches"),
    "pulse_counts": (_pulse, "launches"),
    "pulse_update": (_pulse, "update_launches"),
    "bwd_update": (_bwd, "launches"),
    "bwd_update_conv": (_bwd, "conv_launches"),
    "flash_attention": (_flash, "launches"),
    "key_schedule": (_keys, "launches"),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kind since the last :func:`reset_launch_counts`."""
    return {kind: getattr(mod, attr)
            for kind, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add launches per kind made where no wrapper runs: a CUDA graph's
    replay launches the kernels its capture recorded (negative counts take
    back the wrappers' counts at a capture, which launches nothing)."""
    for kind, n in counts.items():
        mod, attr = _COUNTERS[kind]
        setattr(mod, attr, getattr(mod, attr) + n)


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
              total_rows: Optional[int] = None,
              go: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Kernel-backed raw analog read with the tile API contract (arbitrary
    leading batch dims; per-vector saturation flag); ``go``: the read's
    device predicate (``kernels/noisy_mvm.py``)."""
    r, c = w.shape
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    with torch.profiler.record_function("noisy_read"):
        y2d, sat = _noisy.noisy_mvm(
            w, x2d, fastrng.key_to_seed(key), sigma=_sigma(cfg, transpose),
            alpha=float(cfg.out_bound), n_seg=_n_seg(w, cfg, transpose),
            transpose=transpose, row_offset=row_offset,
            total_rows=total_rows, go=go)
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
    use_bm = _use_bm(cfg)
    use_nm = cfg.noise_management and (backward or cfg.nm_forward)

    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    nm_s = (management.nm_scale(x2d) if use_nm
            else torch.ones(x2d.shape[0], 1, dtype=x2d.dtype,
                            device=x2d.device))
    with torch.profiler.record_function("managed_read"):
        y2d, sat = _managed.managed_mvm(
            w, x2d, nm_s, _read_seeds(key, use_bm),
            sigma=_sigma(cfg, transpose),
            alpha=float(cfg.out_bound), n_seg=_n_seg(w, cfg, transpose),
            transpose=transpose, two_phase=use_bm,
            retry_scale=float(management.TWO_PHASE_SCALE), d_avg=d_avg,
            row_offset=row_offset, total_rows=total_rows)
    out_f = c if transpose else r // d_avg
    return y2d.reshape(*batch_shape, out_f), sat.reshape(batch_shape)


def _use_bm(cfg: RPUConfig) -> bool:
    """Fixed-latency BM on; iterative BM cannot be fused into one read."""
    from repro_torch.core import management
    if management.bm_is_iterative(cfg):
        raise ValueError(
            "iterative BM cannot be fused into one read; use "
            "management.with_bound_management over noisy_mvm")
    return management.bounded(cfg)


def _read_seeds(key: prng.Key, use_bm: bool) -> Tuple[int, int]:
    """A two-phase read consumes ``split(key)``, a single read ``key``."""
    if use_bm:
        k1, k2 = prng.split(key)
        return fastrng.key_to_seed(k1), fastrng.key_to_seed(k2)
    s1 = fastrng.key_to_seed(key)
    return s1, s1


def conv_managed_mvm(w: Tensor, xpad: Tensor, geom, nm_s: Tensor,
                     key: prng.Key, cfg: RPUConfig) -> Tuple[Tensor, Tensor]:
    """Kernel-backed implicit-im2col managed conv read; ``nm_s`` is the
    (positions, 1) per-position scale (ones when NM is off).  Same key ->
    seed discipline as :func:`managed_mvm`."""
    from repro_torch.core import management

    use_bm = _use_bm(cfg)
    with torch.profiler.record_function("managed_read_conv"):
        return _conv.conv_managed_mvm(
            w, xpad.contiguous(), geom, nm_s, _read_seeds(key, use_bm),
            sigma=_sigma(cfg, False), alpha=float(cfg.out_bound),
            two_phase=use_bm,
            retry_scale=float(management.TWO_PHASE_SCALE),
            d_avg=cfg.devices_per_weight)


def _gains(cx: Tensor, cd: Tensor) -> Tuple[Tensor, Tensor]:
    """(C_x, C_d) as two float32 device scalars (views of float32 gains:
    no kernel)."""
    return (cx.reshape(()).to(torch.float32),
            cd.reshape(()).to(torch.float32))


def bwd_update_mvm(w: Tensor, x: Tensor, g_rep: Tensor, read_key: prng.Key,
                   k_a: prng.Key, k_b: prng.Key, cfg: RPUConfig, lr: float,
                   row_offset: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One fused launch for the backward + update cycles of a dense tile:
    the managed transpose read of ``g_rep`` (replicated errors, positive —
    the kernel negates them for the row drivers) under ``read_key`` (as
    :func:`managed_mvm`; NM applies whenever enabled), and the counts of the
    streams of ``x`` and ``-g_rep`` under ``k_a``/``k_b`` with the gains of
    ``management.um_factors``.  ``row_offset`` shifts the stream counters by
    that many rows.  Returns ``(z, residual, count_up, count_dn)`` with
    ``z`` on physical columns."""
    from repro_torch.core import management

    if not cfg.fast_rng:
        raise ValueError("the fused backward+update regenerates the streams "
                         "from the counter hash (fast_rng=True)")
    m_phys, n_cols = w.shape
    use_bm = _use_bm(cfg)
    batch_shape = g_rep.shape[:-1]
    d2d = g_rep.reshape(-1, m_phys).contiguous()
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    nm_s = (management.nm_scale(d2d) if cfg.noise_management
            else torch.ones(d2d.shape[0], 1, dtype=d2d.dtype,
                            device=d2d.device))
    cx, cd = management.um_factors(x2d, -d2d, cfg, lr)
    upd = (fastrng.key_to_seed(k_a), fastrng.key_to_seed(k_b),
           int(row_offset or 0))
    with torch.profiler.record_function("bwd_update"):
        z, sat, up, dn = _bwd.bwd_update_mvm(
            w, d2d, x2d, nm_s, _read_seeds(read_key, use_bm), upd,
            _gains(cx, cd), sigma=_sigma(cfg, True),
            alpha=float(cfg.out_bound), two_phase=use_bm,
            retry_scale=float(management.TWO_PHASE_SCALE), bl=int(cfg.bl))
    return (z.reshape(*batch_shape, n_cols), sat.reshape(batch_shape), up,
            dn)


def conv_bwd_update_mvm(w: Tensor, xpad: Tensor, delta_rep: Tensor, geom,
                        read_key: prng.Key, k_a: prng.Key, k_b: prng.Key,
                        cfg: RPUConfig, lr: float, um_maxima=None
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused backward + update launch for a conv tile: the managed
    transpose read of the replicated position errors ``delta_rep``
    (positions, m_phys) and the streams over the patch columns of ``xpad``,
    built in the kernel.  ``um_maxima`` = precomputed ``(max|x|, max|d|)``
    (required under update management).  Same key discipline as
    :func:`bwd_update_mvm`."""
    from repro_torch.core import management

    if not cfg.fast_rng:
        raise ValueError("the fused backward+update regenerates the streams "
                         "from the counter hash (fast_rng=True)")
    if um_maxima is None and cfg.update_management:
        raise ValueError("update management needs the (x_max, d_max) "
                         "extrema of the conv columns")
    use_bm = _use_bm(cfg)
    delta_rep = delta_rep.contiguous()
    nm_s = (management.nm_scale(delta_rep) if cfg.noise_management
            else torch.ones(delta_rep.shape[0], 1, dtype=delta_rep.dtype,
                            device=delta_rep.device))
    x_max, d_max = um_maxima if um_maxima is not None else (None, None)
    cx, cd = management.um_factors_from_max(x_max, d_max, cfg, lr,
                                            device=delta_rep.device)
    upd = (fastrng.key_to_seed(k_a), fastrng.key_to_seed(k_b))
    with torch.profiler.record_function("bwd_update_conv"):
        return _bwd.conv_bwd_update(
            w, xpad.contiguous(), delta_rep, geom, nm_s,
            _read_seeds(read_key, use_bm), upd, _gains(cx, cd),
            sigma=_sigma(cfg, True), alpha=float(cfg.out_bound),
            two_phase=use_bm, retry_scale=float(management.TWO_PHASE_SCALE),
            bl=int(cfg.bl))


def pulse_counts(streams_rows: Tensor, streams_cols: Tensor,
                 out: Optional[Tuple[Tensor, Tensor]] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Kernel-backed coincidence counts of signed streams ``(..., BL, M)``
    and ``(..., BL, N)`` (leading axes and BL contracted); with ``out``,
    added to those counts."""
    m = streams_rows.shape[-1]
    n = streams_cols.shape[-1]
    with torch.profiler.record_function("pulse_counts"):
        return _pulse.pulse_counts(streams_rows.reshape(-1, m).contiguous(),
                                   streams_cols.reshape(-1, n).contiguous(),
                                   out)


def pulse_update_fused(w: Tensor, maps: DeviceMaps, streams_rows: Tensor,
                       streams_cols: Tensor, key: prng.Key,
                       cfg: RPUConfig) -> Tensor:
    """Kernel-backed update cycle in one launch; streams already sampled
    ``(..., BL, n)``.  The ctoc noise consumes ``key_to_seed(key)``."""
    m, n = w.shape
    with torch.profiler.record_function("pulse_update"):
        return _pulse.pulse_update(
            w, maps.dw_up, maps.dw_dn, maps.bound,
            streams_rows.reshape(-1, m).contiguous(),
            streams_cols.reshape(-1, n).contiguous(),
            fastrng.key_to_seed(key), ctoc=float(cfg.dw_min_ctoc))
