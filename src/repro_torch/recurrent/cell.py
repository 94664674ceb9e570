"""Analog LSTM/GRU cells: *temporal* weight reuse on RPU crossbar tiles.

Port of the JAX package's ``recurrent/cell.py`` (after "Training LSTM
Networks with Resistive Cross-Point Devices", 1806.00166).  The input
projection ``W_x`` and the recurrent projection ``W_h`` each live on one
crossbar tile whose weights are

* **read every timestep**: the forward performs one managed analog read
  per gate tile per timestep (``tile_forward`` with NM/BM) under
  ``fold_in(k_fx, t)`` and ``fold_in(k_fh, t)``;
* **transpose-read every timestep**: the backward (BPTT) sweeps time in
  reverse and makes the managed transpose read per timestep (under
  ``fold_in(k_bx, t)`` / ``fold_in(k_bh, t)``) to chain ``dh`` and produce
  ``dx``;
* **updated ONCE per training step**: each timestep's (driver, error) pair
  adds its integer coincidence counts at the counter offset ``row_offset =
  t * B`` (rows flattened timestep-major) to the counts of the timesteps
  after it, and ``update.finalize_counts`` (device maps, cycle-to-cycle
  noise, per-device bound clip) runs once per tile per step.

The pulse-stream counters of timestep ``t`` are the ``[tB, tB + B)`` row
slice of the single-shot stream over all ``T * B`` flattened pairs, so the
accumulated update is bit-identical to one ``update.pulse_update`` over the
stacked pairs: ``recurrent/oracle.py`` is that unrolled reference.

The JAX package scans over time inside one XLA program (``time_chunk``
timesteps per scan body).  Here the time loop is a host loop, so a
captured training step (``train/engine.py``) records every timestep's
launches; ``time_chunk`` is validated as in JAX (it must divide ``T``) and
changes no bit.

With ``cfg.fuse_bwd_update`` (and both tiles eligible) each timestep's
transpose read and counts are ONE fused launch (``ops.bwd_update_mvm`` at
the timestep's ``row_offset``): the same counters and counts, still one
finalize per step.  The separate route counts with ``update.stream_counts``
into the counts of the later timesteps (the pulse-count kernel's
accumulate path under ``use_pallas``).

Constraints (checked on every analog forward): no update management (UM
gains need the global extrema of every timestep's drivers and errors,
which exist only after the backward sweep), ``fast_rng`` on (the
counter-offset streams are what make the accumulation exact), one tile (no
``tile_grid``).

The cell's weight cotangent follows the repo-wide convention ``w_bar :=
W - clip(W + DW_pulse)``, so ``optim.analog_sgd`` (``p - g``) lands the
weights on the physically updated value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analog.modules import AnalogState
from repro_torch.core import management
from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.core.tile import div_replicas, replicate_delta
from repro_torch.utils import prng

Tensor = torch.Tensor
Params = Dict[str, Any]

GATES = {"lstm": 4, "gru": 3}


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Static cell geometry and routing.

    ``time_chunk``: timesteps per scan chunk in the JAX package; ``None``
    is one chunk of the whole sequence.  It must divide ``T`` and changes
    no bit (the parity contract).
    """
    kind: str = "lstm"
    hidden: int = 32
    time_chunk: Optional[int] = 1
    bias: bool = True

    def __post_init__(self):
        if self.kind not in GATES:
            raise ValueError(f"unknown recurrent cell kind: {self.kind!r}")

    @property
    def gates(self) -> int:
        return GATES[self.kind]


# ---------------------------------------------------------------------------
# Init (plain dense sites -> convert_to_analog rewrites them to tiles)
# ---------------------------------------------------------------------------

def init_cell(key: prng.Key, d_in: int, spec: CellSpec, *,
              device="cpu") -> Params:
    """Cell params as two *plain dense sites* ``{"wx": {"w", "b"}, "wh":
    {"w"}}``, the JAX package's draws from the same key, so that
    ``analog.convert.convert_to_analog`` (path-keyed seeds) can rewrite
    either or both onto crossbar tiles."""
    g, h = spec.gates, spec.hidden
    kx, kh = prng.split(key)
    sx, sh = d_in ** -0.5, h ** -0.5
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    wx = as_t(prng.uniform(kx, (d_in, g * h), -sx, sx))
    b = torch.zeros(g * h, dtype=torch.float32, device=device)
    if spec.kind == "lstm":
        # forget-gate bias 1.0: the standard keep-by-default init
        b[h:2 * h] = 1.0
    wh = as_t(prng.uniform(kh, (h, g * h), -sh, sh))
    return {"wx": {"w": wx, "b": b}, "wh": {"w": wh}}


# ---------------------------------------------------------------------------
# Gate nonlinearities (shared fwd/bwd; recomputed from pre-activations)
# ---------------------------------------------------------------------------

def _split_gates(a: Tensor, n: int):
    return torch.chunk(a, n, dim=-1)


def _nonlin_fwd(spec: CellSpec, ax: Tensor, bh: Tensor, h: Tensor,
                c: Tensor) -> Tuple[Tensor, Tensor]:
    """(h', c') from the two tile reads.  ``c`` is carried but unused for
    GRU (kept as it is) so both kinds share one signature."""
    if spec.kind == "lstm":
        ai, af, ag, ao = _split_gates(ax + bh, 4)
        i, f = torch.sigmoid(ai), torch.sigmoid(af)
        g, o = torch.tanh(ag), torch.sigmoid(ao)
        c2 = f * c + i * g
        return o * torch.tanh(c2), c2
    axr, axz, axn = _split_gates(ax, 3)
    bhr, bhz, bhn = _split_gates(bh, 3)
    r = torch.sigmoid(axr + bhr)
    z = torch.sigmoid(axz + bhz)
    n = torch.tanh(axn + r * bhn)
    return (1.0 - z) * n + z * h, c


def _nonlin_bwd(spec: CellSpec, ax: Tensor, bh: Tensor, hp: Tensor,
                cp: Tensor, dh: Tensor, dc: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Digital gate backward: (delta_x, delta_h, dh_prev_local, dc_prev).

    ``delta_x``/``delta_h`` are the gate pre-activation errors driving the
    ``W_x``/``W_h`` tiles (identical for LSTM; GRU's new-gate row is scaled
    by the reset gate on the recurrent side).  ``dh_prev_local`` is the
    part of ``dh_{t-1}`` that does NOT flow through the ``W_h`` transpose
    read (zero for LSTM, ``z * dh`` for GRU).
    """
    if spec.kind == "lstm":
        ai, af, ag, ao = _split_gates(ax + bh, 4)
        i, f = torch.sigmoid(ai), torch.sigmoid(af)
        g, o = torch.tanh(ag), torch.sigmoid(ao)
        c2 = f * cp + i * g
        tc2 = torch.tanh(c2)
        dct = dc + dh * o * (1.0 - tc2 * tc2)
        d_ai = dct * g * i * (1.0 - i)
        d_af = dct * cp * f * (1.0 - f)
        d_ag = dct * i * (1.0 - g * g)
        d_ao = dh * tc2 * o * (1.0 - o)
        delta = torch.cat([d_ai, d_af, d_ag, d_ao], dim=-1)
        return delta, delta, torch.zeros_like(dh), dct * f
    axr, axz, axn = _split_gates(ax, 3)
    bhr, bhz, bhn = _split_gates(bh, 3)
    r = torch.sigmoid(axr + bhr)
    z = torch.sigmoid(axz + bhz)
    n = torch.tanh(axn + r * bhn)
    dn = dh * (1.0 - z)
    dpre_n = dn * (1.0 - n * n)
    dz = dh * (hp - n)
    dpre_z = dz * z * (1.0 - z)
    dr = dpre_n * bhn
    dpre_r = dr * r * (1.0 - r)
    delta_x = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
    delta_h = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
    return delta_x, delta_h, dh * z, torch.zeros_like(dc)


# ---------------------------------------------------------------------------
# The temporal-accumulation contract
# ---------------------------------------------------------------------------

def _augment(spec: CellSpec, x: Tensor) -> Tensor:
    if not spec.bias:
        return x
    ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)


def _check_cfg(cfg: RPUConfig) -> None:
    if cfg.update_management:
        raise ValueError(
            "temporal pulse accumulation cannot honor update management: "
            "UM gains need the global scalar extrema of every timestep's "
            "drivers/errors, which only exist after the backward sweep — "
            "use an NM/BM policy (e.g. 'managed') for recurrent tiles")
    if not cfg.fast_rng:
        raise ValueError(
            "scan-over-time analog cells require cfg.fast_rng: the "
            "counter-offset pulse streams are what make chunked updates "
            "bit-identical to the unrolled cycle")
    if cfg.tile_grid is not None and tuple(cfg.tile_grid) != (1, 1):
        raise NotImplementedError(
            "recurrent cells are single-tile; tile_grid sharding of the "
            "temporal accumulation is not routed yet")


def _split3(key: prng.AnyKey) -> List[prng.AnyKey]:
    return prng.split(key, 3)


def _chunks(spec: CellSpec, t_total: int) -> Tuple[int, int]:
    tc = t_total if spec.time_chunk is None else int(spec.time_chunk)
    if tc < 1 or t_total % tc:
        raise ValueError(
            f"time_chunk={spec.time_chunk} must divide the sequence "
            f"length T={t_total} (pad the sequence or pick a divisor)")
    return t_total // tc, tc


def _fuse_temporal(cfg: RPUConfig, wx: Tensor, wh: Tensor) -> bool:
    """Routing: fused per-timestep backward+update launches for BOTH
    tiles, else the separate-launch cycles for both (the oracle)."""
    if not cfg.fuse_bwd_update:
        return False
    from repro_torch.kernels.bwd_update_mvm import bwd_update_eligible
    return (bwd_update_eligible(cfg, tuple(wx.shape))
            and bwd_update_eligible(cfg, tuple(wh.shape)))


Counts = Tuple[Tensor, Tensor]


def tile_cycles(w: Tensor, col_drv: Tensor, delta: Tensor,
                k_read: prng.AnyKey, k_a: prng.AnyKey, k_b_upd: prng.AnyKey,
                row0: int, cfg: RPUConfig, lr: float, cx: Tensor,
                cd: Tensor, fused: bool, d: int,
                out: Optional[Counts] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One row block's backward+update cycles for one tile: the managed
    transpose read of ``delta`` under ``k_read`` and the block's
    coincidence counts at ``row_offset = row0`` in the timestep-major
    flattened pulse stream, added to ``out`` when given.  Returns ``(z,
    up, dn)``.  Shared by the recurrent cell's BPTT sweep and the
    non-recurrent :mod:`repro_torch.recurrent.temporal` dense: one
    implementation of the temporal-accumulation contract."""
    if fused:
        from repro_torch.kernels import ops as kops
        g_rep = replicate_delta(delta, d, rows_phys=w.shape[0])
        z, _sat, up, dn = kops.bwd_update_mvm(
            w, col_drv, g_rep, k_read, k_a, k_b_upd, cfg, lr,
            row_offset=row0)
        if d > 1:
            z = div_replicas(z, d)
        if out is not None:
            up, dn = out[0].add_(up), out[1].add_(dn)
        return z, up, dn
    z = tile_lib.tile_backward(w, delta, k_read, cfg)
    d_rep = replicate_delta(-delta, d, rows_phys=w.shape[0])
    up, dn = update_lib.stream_counts(col_drv, d_rep, cx, cd, k_a, k_b_upd,
                                      cfg, row_offset=row0, out=out)
    return z, up, dn


def constant_gains(cfg: RPUConfig, lr: float, device) -> Tuple[Tensor,
                                                                Tensor]:
    """The pulse gains ``(C_x, C_d)``: constant, since UM is refused."""
    return management.um_factors_from_max(None, None, cfg, lr,
                                          device=device)


def tile_maps(state: AnalogState, cfg: RPUConfig) -> DeviceMaps:
    """A tile's device maps: stored, or regenerated from its seed under
    seeded maps (as ``AnalogLinear.apply`` takes them)."""
    return tile_lib.tile_maps(state.w, None if cfg.seeded_maps
                              else state.maps, state.seed, cfg)


# ---------------------------------------------------------------------------
# Analog time loop (autograd.Function)
# ---------------------------------------------------------------------------

def _forward_loop(spec: CellSpec, cfg: RPUConfig, wx: Tensor, wh: Tensor,
                  xs: Tensor, h0: Tensor, c0: Tensor, k_f: prng.AnyKey):
    """Forward: one managed read per gate tile per timestep.  Returns
    ``(hs, h_T, c_T)`` and the per-timestep residuals ``(ax, bh, h_prev,
    c_prev, x_aug)`` the BPTT sweep recomputes the gates from."""
    k_fx, k_fh = prng.split(k_f)
    h, c = h0, c0
    hs, res = [], []
    for t in range(xs.shape[0]):
        xa = _augment(spec, xs[t])
        ax = tile_lib.tile_forward(wx, xa, prng.fold_in(k_fx, t), cfg)
        bh = tile_lib.tile_forward(wh, h, prng.fold_in(k_fh, t), cfg)
        h2, c2 = _nonlin_fwd(spec, ax, bh, h, c)
        res.append((ax, bh, h, c, xa))
        hs.append(h2)
        h, c = h2, c2
    return torch.stack(hs), h, c, res


class _AnalogScan(torch.autograd.Function):
    """Forward: the time loop of managed reads under ``split3(key)[0]``.
    Backward: the reverse sweep of transpose reads and accumulated counts
    under ``split3(key)[1:]``, one finalize per tile; returns ``w_bar = w -
    new_w`` for both tiles and the input cotangents."""

    @staticmethod
    def forward(ctx, spec, cfg, wx, wh, xs, h0, c0, tiles, key, lr):
        _check_cfg(cfg)
        _chunks(spec, xs.shape[0])
        k_f, _, _ = _split3(key)
        hs, h_t, c_t, res = _forward_loop(spec, cfg, wx, wh, xs, h0, c0,
                                          k_f)
        ctx.save_for_backward(wx, wh)
        ctx.spec, ctx.cfg, ctx.tiles, ctx.key, ctx.lr = spec, cfg, tiles, \
            key, lr
        ctx.res, ctx.d_in = res, xs.shape[-1]
        # GRU carries c unchanged: an output must not be an input
        return hs, h_t, c_t.clone() if c_t is c0 else c_t

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        wx, wh = ctx.saved_tensors
        spec, cfg, lr, res = ctx.spec, ctx.cfg, ctx.lr, ctx.res
        tx, th = ctx.tiles
        t_total, b = len(res), res[0][2].shape[0]
        d = cfg.devices_per_weight

        _, k_b, k_u = _split3(ctx.key)
        k_bx, k_bh = prng.split(k_b)
        k_ux, k_uh = prng.split(k_u)
        # update.pulse_update's 3-way split of its key: A-stream, B-stream,
        # ctoc (k_c stays for the single shared finalize)
        k_xa, k_xb, k_xc = prng.split(k_ux, 3)
        k_ha, k_hb, k_hc = prng.split(k_uh, 3)
        cx, cd = constant_gains(cfg, lr, wx.device)
        fused = _fuse_temporal(cfg, wx, wh)

        dh, dc = g_ht, g_ct
        acc_x = acc_h = None
        dxs: List[Optional[Tensor]] = [None] * t_total
        for t in reversed(range(t_total)):
            ax, bh, hp, cp, xa = res[t]
            dh = dh + g_hs[t]
            delta_x, delta_h, dh_loc, dc_prev = _nonlin_bwd(
                spec, ax, bh, hp, cp, dh, dc)
            zx, *acc_x = tile_cycles(wx, xa, delta_x,
                                     prng.fold_in(k_bx, t), k_xa, k_xb,
                                     t * b, cfg, lr, cx, cd, fused, d,
                                     acc_x)
            zh, *acc_h = tile_cycles(wh, hp, delta_h,
                                     prng.fold_in(k_bh, t), k_ha, k_hb,
                                     t * b, cfg, lr, cx, cd, fused, d,
                                     acc_h)
            acc_x, acc_h = tuple(acc_x), tuple(acc_h)
            dh, dc = dh_loc + zh, dc_prev
            dxs[t] = zx[..., :ctx.d_in]           # drop the bias column
        ctx.res = None

        # ONE shared digital finalize per tile per training step
        new_wx = update_lib.finalize_counts(wx, tile_maps(tx, cfg), *acc_x,
                                            k_xc, cfg)
        new_wh = update_lib.finalize_counts(wh, tile_maps(th, cfg), *acc_h,
                                            k_hc, cfg)
        return (None, None, wx - new_wx, wh - new_wh, torch.stack(dxs), dh,
                dc, None, None, None)


# ---------------------------------------------------------------------------
# Public apply
# ---------------------------------------------------------------------------

def _as_tile(p) -> AnalogState:
    if isinstance(p, AnalogState):
        return p
    raise TypeError(
        "analog cell_apply expects AnalogState tiles (run "
        "repro_torch.analog.convert.convert_to_analog over the cell "
        f"params); got {type(p).__name__}")


def cell_apply(params: Params, xs: Tensor, spec: CellSpec, *,
               h0: Optional[Tensor] = None, c0: Optional[Tensor] = None,
               key: Optional[prng.AnyKey] = None, lr: float = 1.0,
               cfg: Optional[RPUConfig] = None
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run the cell over a time-major batch ``xs`` (T, B, d_in).

    Dispatches on the parameter type: plain ``{"w"[, "b"]}`` dicts run the
    exact FP cell (torch autograd); ``AnalogState`` tiles run the RPU time
    loop (managed per-timestep reads, temporally accumulated pulse update
    in the backward pass).  Returns ``(hs, h_T, c_T)`` with ``hs``: (T, B,
    H).
    """
    b, h = xs.shape[1], spec.hidden
    if h0 is None:
        h0 = torch.zeros(b, h, dtype=xs.dtype, device=xs.device)
    if c0 is None:
        c0 = torch.zeros(b, h, dtype=xs.dtype, device=xs.device)

    if not isinstance(params["wx"], AnalogState):
        hh, cc = h0, c0
        hs = []
        for t in range(xs.shape[0]):
            ax = xs[t] @ params["wx"]["w"] + params["wx"]["b"]
            bh = hh @ params["wh"]["w"]
            hh, cc = _nonlin_fwd(spec, ax, bh, hh, cc)
            hs.append(hh)
        return torch.stack(hs), hh, cc

    if key is None:
        raise ValueError("analog cells draw physical read noise every "
                         "timestep: pass a PRNG key")
    sx, sh = _as_tile(params["wx"]), _as_tile(params["wh"])
    acfg = sx.meta.cfg if cfg is None else cfg
    spec = dataclasses.replace(spec, bias=sx.meta.bias)
    dt = sx.w.dtype
    return _AnalogScan.apply(spec, acfg, sx.w, sh.w, xs.to(dt), h0.to(dt),
                             c0.to(dt), (sx, sh), key, float(lr))
