"""AnalogTile: the physical RPU crossbar array — its reads and its update.

A tile holds the physical weights ``(#_d * out_f, in_f)`` of one logical
matrix.  Every read draws fresh Gaussian noise (sigma) and clips at the
integrator bound (+-alpha); contractions longer than the physical array
(4096, paper Discussion) split into segments, each an independent physical
read whose noise and bound apply before the digital sum.

The backward cycle reads ``W^T delta`` with the error replicated to the
#_d physical row blocks (:func:`replicate_delta`); with
``cfg.fuse_bwd_update`` the backward read and the pulse update of a layer
run as one kernel launch (:func:`tile_backward_update`).

``cfg.use_pallas`` routes the reads through the CUDA kernels
(``repro_torch.kernels``); otherwise the plain-PyTorch reference below runs
(it is also the kernels' oracle).  A tile with a sub-tile grid
(``cfg.tile_grid`` other than (1, 1)) runs its cycles through
``core/tile_grid.py``, one raw read per block, never the managed-read
kernel.  A read of one chunk of a larger batch (the streaming conv cycles,
``core/conv_mapping.py``) passes ``row_offset`` and ``total_rows``: its
noise is drawn at its rows' counters in the whole read, and the kernels
plan it as the whole read, so the chunk's rows come out bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import management
from repro_torch.core.device import DeviceMaps, RPUConfig, sample_device_maps
from repro_torch.utils import fastrng, prng

Tensor = torch.Tensor


def _num_splits(contraction_dim: int, limit: int) -> int:
    return max(1, -(-contraction_dim // limit))


def _grid_routed(cfg: RPUConfig) -> bool:
    """True when the tile's cycles run on its sub-tile grid
    (``core/tile_grid.py``); the trivial (1, 1) grid stays on the plain
    single-tile path, which it equals bit for bit."""
    return cfg.tile_grid is not None and tuple(cfg.tile_grid) != (1, 1)


def init_tile(key: prng.Key, out_features: int, in_features: int,
              cfg: RPUConfig, init_scale: Optional[float] = None, *,
              w_init: Optional[Tensor] = None,
              device="cpu") -> Tuple[Tensor, Optional[DeviceMaps], prng.Key]:
    """A new tile ``(w, maps, seed)``: the initial weights ``w_init``
    ``(out, in)``, or uniform ones within ``+-min(1/sqrt(in), w_bound/2)``,
    replicated over the #_d device rows, and the device maps sampled from
    the seed (None with seeded maps, else the weights clipped to each
    device's own bound)."""
    k_w, k_dev = prng.split(key)
    if w_init is None:
        if init_scale is None:
            init_scale = min(1.0 / (in_features ** 0.5), cfg.w_bound / 2.0)
        w_init = torch.from_numpy(prng.uniform(
            k_w, (out_features, in_features), -init_scale, init_scale))
    w = w_init.to(device=device, dtype=cfg.dtype).repeat(
        cfg.devices_per_weight, 1)
    maps = None
    if not cfg.seeded_maps:
        maps = sample_device_maps(k_dev, w.shape[0], w.shape[1], cfg,
                                  device=device)
        w = torch.clamp(w, -maps.bound, maps.bound)
    return w.contiguous(), maps, k_dev


def tile_maps(w: Tensor, maps: Optional[DeviceMaps], seed: prng.Key,
              cfg: RPUConfig) -> DeviceMaps:
    """Device maps: stored, or regenerated from the tile seed."""
    if maps is not None:
        return maps
    return sample_device_maps(seed, w.shape[0], w.shape[1], cfg,
                              device=w.device)


def analog_mvm(w: Tensor, x: Tensor, key: prng.Key, cfg: RPUConfig, *,
               transpose: bool = False, row_offset: Optional[int] = None,
               total_rows: Optional[int] = None,
               go: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One physical array read ``y = clip(W x + sigma*xi, +-alpha)`` with
    contraction splits; returns ``(y, sat)`` with a per-vector flag.  A
    read with ``go`` (a 0-d bool device tensor: a predicated BM retry)
    leaves its outputs undefined where ``go`` is false; the kernel then
    returns at once, the plain version reads all the same."""
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.noisy_mvm(w, x, key, cfg, transpose=transpose,
                              row_offset=row_offset, total_rows=total_rows,
                              go=go)
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


def managed_mvm_reference(w: Tensor, x: Tensor, key: prng.Key,
                          cfg: RPUConfig, *, transpose: bool = False,
                          backward: bool = False,
                          row_offset: Optional[int] = None,
                          total_rows: Optional[int] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain managed read: NM scale (once) + BM over raw reference reads,
    on physical output channels (the #_d average is the caller's step)."""
    def mvm(xx, kk, go=None):
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
    its retries over one ``noisy_mvm`` kernel launch per read (on a device
    predicate under a key tape's key, ``management``).  A sub-tile grid
    routes first: one ``noisy_mvm`` launch per block read, under any BM
    mode (``core/tile_grid.py``).
    """
    if _grid_routed(cfg):
        from repro_torch.core import tile_grid
        return tile_grid.grid_tile_forward(w, x, key, cfg,
                                           return_sat=return_sat,
                                           row_offset=row_offset,
                                           total_rows=total_rows)
    if cfg.use_pallas and not management.bm_is_iterative(cfg):
        from repro_torch.kernels import ops as kops
        y, sat = kops.managed_mvm(w, x, key, cfg, transpose=False,
                                  backward=False, row_offset=row_offset,
                                  total_rows=total_rows)
        return (y, sat) if return_sat else y

    def mvm(xx, kk, go=None):
        return analog_mvm(w, xx, kk, cfg, transpose=False,
                          row_offset=row_offset, total_rows=total_rows,
                          go=go)

    y_phys, sat = management.with_management(mvm, x, key, cfg,
                                             backward=False)
    y = _replica_mean(y_phys, cfg.devices_per_weight)
    return (y, sat) if return_sat else y


def replicate_delta(delta: Tensor, d: int,
                    rows_phys: Optional[int] = None) -> Tensor:
    """Replicate a logical error ``(..., out_f)`` to the #_d-replicated
    physical row layout ``(..., #_d * out_f)`` (replica blocks side by
    side); ``rows_phys`` pins the result against the physical row count."""
    if d > 1:
        delta = delta.repeat(*([1] * (delta.dim() - 1)), d)
    if rows_phys is not None and delta.shape[-1] != rows_phys:
        raise ValueError(f"replicated delta {tuple(delta.shape)} does not "
                         f"match {rows_phys} physical rows")
    return delta


def div_replicas(z: Tensor, d: int) -> Tensor:
    """``z / d`` as a product with the float32 reciprocal of ``d``: how XLA
    rounds a division by a constant in the JAX package's compiled steps, and
    how torch divides a CUDA tensor by a Python number."""
    return z * float(np.float32(1.0) / np.float32(d))


def tile_backward(w: Tensor, delta: Tensor, key: prng.Key, cfg: RPUConfig,
                  *, return_sat: bool = False,
                  row_offset: Optional[int] = None,
                  total_rows: Optional[int] = None):
    """Backward cycle ``z = W_eff^T delta``: the error drives all #_d
    replica row blocks, the column currents sum over replicas and the
    digital domain divides by #_d.  Routing mirrors :func:`tile_forward`
    (NM applies to the backward read whenever enabled)."""
    d = cfg.devices_per_weight
    delta = replicate_delta(delta, d, rows_phys=w.shape[0])
    if _grid_routed(cfg):
        from repro_torch.core import tile_grid
        return tile_grid.grid_tile_backward(w, delta, key, cfg,
                                            return_sat=return_sat,
                                            row_offset=row_offset,
                                            total_rows=total_rows)
    if cfg.use_pallas and not management.bm_is_iterative(cfg):
        from repro_torch.kernels import ops as kops
        z, sat = kops.managed_mvm(w, delta, key, cfg, transpose=True,
                                  backward=True, row_offset=row_offset,
                                  total_rows=total_rows)
    else:
        def mvm(dd, kk, go=None):
            return analog_mvm(w, dd, kk, cfg, transpose=True,
                              row_offset=row_offset, total_rows=total_rows,
                              go=go)

        z, sat = management.with_management(mvm, delta, key, cfg,
                                            backward=True)
    if d > 1:
        z = div_replicas(z, d)
    return (z, sat) if return_sat else z


def tile_backward_update(w: Tensor, maps: DeviceMaps, x: Tensor, g: Tensor,
                         k_read: prng.Key, k_upd: prng.Key, cfg: RPUConfig,
                         lr: float) -> Tuple[Tensor, Tensor]:
    """Backward and update cycles in one fused kernel launch
    (``kernels/bwd_update_mvm.py``): exactly :func:`tile_backward` under
    ``k_read`` followed by the pulse update of ``(x, -g)`` under ``k_upd``
    (its 3-way split into A-stream, B-stream and ctoc keys), with the same
    digital :func:`update.finalize_counts`.  Callers gate on
    ``kernels.bwd_update_mvm.bwd_update_eligible``.  Returns ``(z, new_w)``:
    the replica-averaged transpose read and the updated weights."""
    from repro_torch.core import update as update_lib
    from repro_torch.kernels import ops as kops

    d = cfg.devices_per_weight
    g_rep = replicate_delta(g, d, rows_phys=w.shape[0])
    k_a, k_b, k_c = prng.split(k_upd, 3)
    z, _sat, count_up, count_dn = kops.bwd_update_mvm(
        w, x, g_rep, k_read, k_a, k_b, cfg, lr)
    if d > 1:
        z = div_replicas(z, d)
    return z, update_lib.finalize_counts(w, maps, count_up, count_dn, k_c,
                                         cfg)


def tile_update(w: Tensor, maps: Optional[DeviceMaps], seed: prng.Key,
                x: Tensor, delta: Tensor, key: prng.Key, cfg: RPUConfig,
                lr: float) -> Tensor:
    """Update cycle: the stochastic-pulse outer-product update (Eq. 1) of
    the activations ``x`` and errors ``delta``; leading axes are flattened
    into serial vector pairs.  Returns the new physical weights."""
    from repro_torch.core import update as update_lib
    return update_lib.pulse_update(w, tile_maps(w, maps, seed, cfg), x,
                                   delta, key, cfg, lr)
