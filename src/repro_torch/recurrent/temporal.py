"""Temporal accumulate-across-time analog dense: weight reuse, no recurrence.

Port of the JAX package's ``recurrent/temporal.py``.  The recurrent cell
reads its tiles every timestep and accumulates ONE pulse update across the
whole sequence.  The same contract applies to any *shared* projection
applied position by position over a sequence axis (the SSD block's in/out
projections, a time-distributed readout), where nothing recurs but the
tile is still reused ``T`` times per training step:

* forward: one managed ``tile_forward`` read per timestep under
  ``fold_in(k_f, t)``;
* backward: one managed transpose read per timestep under ``fold_in(k_b,
  t)``, and the timestep's coincidence counts at ``row_offset = t * B`` in
  the timestep-major flattened pulse stream (``cell.tile_cycles``, the
  helper the cell's BPTT sweep uses);
* update: ``update.finalize_counts`` exactly ONCE per tile per step.

The counts are exact integers carried in float32, so the accumulated
update is the single-shot ``update.pulse_update`` over all ``T * B`` stacked
pairs bit for bit, for every ``time_chunk`` (validated, as in the cell, and
changing no bit: the time loop is a host loop).

The config constraints are the cell's (:func:`repro_torch.recurrent.cell.
_check_cfg`); :func:`temporal_eligible` tests them without raising, so a
caller can fall back to the single-shot ``AnalogLinear`` cycle, which is
what a UM config requires.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analog.modules import AnalogState
from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import RPUConfig
from repro_torch.recurrent.cell import (_check_cfg, _split3, constant_gains,
                                        tile_cycles, tile_maps)
from repro_torch.utils import prng

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TemporalSpec:
    """Static geometry and routing of one temporal dense."""
    bias: bool = True
    time_chunk: Optional[int] = None     # None: single chunk (whole T)


def temporal_eligible(cfg: RPUConfig) -> bool:
    """True when ``cfg`` supports streamed temporal accumulation."""
    return (not cfg.update_management and cfg.fast_rng
            and (cfg.tile_grid is None or tuple(cfg.tile_grid) == (1, 1)))


def _check_chunk(spec: TemporalSpec, t_total: int) -> None:
    tc = t_total if spec.time_chunk is None else int(spec.time_chunk)
    if tc < 1 or t_total % tc:
        raise ValueError(
            f"time_chunk={spec.time_chunk} must divide the sequence "
            f"length T={t_total}")


def _aug(spec: TemporalSpec, x: Tensor) -> Tensor:
    if not spec.bias:
        return x
    ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)


def _fuse(cfg: RPUConfig, w: Tensor) -> bool:
    if not cfg.fuse_bwd_update:
        return False
    from repro_torch.kernels.bwd_update_mvm import bwd_update_eligible
    return bwd_update_eligible(cfg, tuple(w.shape))


class _TemporalMVM(torch.autograd.Function):
    """Forward: ``T`` reads under ``split3(key)[0]``; backward: ``T``
    transpose reads and accumulated counts in time order, one finalize;
    returns ``w_bar = w - new_w`` and the inputs' cotangent."""

    @staticmethod
    def forward(ctx, spec, cfg, w, xs, state, key, lr):
        _check_cfg(cfg)
        _check_chunk(spec, xs.shape[0])
        k_f, _, _ = _split3(key)
        ys = torch.stack([
            tile_lib.tile_forward(w, _aug(spec, xs[t]), prng.fold_in(k_f, t),
                                  cfg) for t in range(xs.shape[0])])
        ctx.save_for_backward(w, xs)
        ctx.spec, ctx.cfg, ctx.state, ctx.key, ctx.lr = spec, cfg, state, \
            key, lr
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        w, xs = ctx.saved_tensors
        spec, cfg, lr, state = ctx.spec, ctx.cfg, ctx.lr, ctx.state
        t_total, b = xs.shape[0], xs.shape[1]
        _, k_b, k_u = _split3(ctx.key)
        # update.pulse_update's 3-way split: A-stream, B-stream, ctoc (k_c
        # stays for the single shared finalize)
        k_a, k_b2, k_c = prng.split(k_u, 3)
        cx, cd = constant_gains(cfg, lr, w.device)
        fused = _fuse(cfg, w)
        acc = None
        dxs = []
        for t in range(t_total):
            z, *acc = tile_cycles(w, _aug(spec, xs[t]), g_ys[t],
                                  prng.fold_in(k_b, t), k_a, k_b2, t * b,
                                  cfg, lr, cx, cd, fused,
                                  cfg.devices_per_weight, acc)
            acc = tuple(acc)
            dxs.append(z[..., :xs.shape[-1]])
        new_w = update_lib.finalize_counts(w, tile_maps(state, cfg), *acc,
                                           k_c, cfg)
        return (None, None, w - new_w, torch.stack(dxs), None, None, None)


def temporal_dense_apply(state: AnalogState, xs: Tensor,
                         key: prng.AnyKey, *, lr: float = 1.0,
                         time_chunk: Optional[int] = None,
                         cfg: Optional[RPUConfig] = None) -> Tensor:
    """Apply one analog dense tile across a time-major batch ``xs`` (T, B,
    d_in) with accumulate-across-time updates.

    Drop-in for ``AnalogLinear.apply`` over a sequence: the same w_bar
    convention (``W - clip(W + DW_pulse)``), but the backward pass emits ONE
    temporally accumulated pulse update instead of one single-shot cycle
    over the materialized (T*B) pair stack.  ``time_chunk`` must divide T
    (``None``: one chunk).
    """
    acfg = state.meta.cfg if cfg is None else cfg
    if key is None:
        raise ValueError("analog reads draw physical noise every "
                         "timestep: pass a PRNG key")
    spec = TemporalSpec(bias=state.meta.bias, time_chunk=time_chunk)
    w = state.w
    return _TemporalMVM.apply(spec, acfg, w, xs.to(w.dtype), state, key,
                              float(lr))
