"""Mamba-2 SSD (state-space duality) block: mamba2-130m and the SSM branch
of hymba-1.5b.

The selective state space recurrence per head (state size N, head dim P):

    h_t = a_t * h_{t-1} + dt_t * (B_t (x) x_t)        a_t = exp(dt_t * A)
    y_t = C_t . h_t + D * x_t

computed with the chunked SSD algorithm (arXiv:2405.21060): the sequence is
split into chunks of Q tokens; within a chunk the contribution is a masked
``(C B^T * decay) x`` product, quadratic only in Q, and one state tensor
(B, H, P, N) is carried from chunk to chunk by a Python loop (the JAX
package's ``lax.scan``).  All recurrence math runs in float32, as plain
torch products: the JAX package computes the scan outside any Pallas
kernel too.

The in/out projections are the block's dense sites, so an analog policy
makes them tiles.  Over a sequence (S > 1) an analog projection whose
config allows temporal accumulation (no update management, fast_rng, no
grid: ``recurrent.temporal.temporal_eligible``) reads once per position
through ``temporal_dense_apply`` in time chunks of the largest divisor of
S that is at most the SSD chunk; every other projection, and every decode
step, takes the single-shot ``L.dense_apply``.  Read keys: ``fold_in(akey,
0)`` for ``in_proj`` and ``fold_in(akey, 1)`` for ``out_proj``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.analog.modules import AnalogState
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils import prng

Tensor = torch.Tensor


def dims(cfg: ModelConfig):
    """``(d_inner, heads, head dim P, state N)``."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.d_head, s.d_head, s.d_state


def a_log_init(h: int, device) -> Tensor:
    """``log(linspace(1, 16, H))`` in float32."""
    return torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                    device=device))


def init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Digital parameters (analog conversion is policy-driven)."""
    d = cfg.d_model
    d_in, h, _, n = dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * n + h,
                                cfg.param_dtype, device),
        "out_proj": L.dense_init(gen, d_in, d, cfg.param_dtype, device),
        # depthwise causal conv over [x, B, C]
        "conv_w": L.truncated_normal_init(gen, (cfg.ssm.d_conv, conv_ch),
                                          conv_ch ** -0.5, cfg.param_dtype,
                                          device),
        "A_log": a_log_init(h, device),
        "D": torch.ones(h, dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=device),
        "norm": L.rmsnorm_init(d_in, cfg.param_dtype, device),
    }


def _seq_dense(p, x: Tensor, key, chunk: int) -> Tensor:
    """Dense site over a (B, S, d) sequence: temporally accumulated when
    analog and eligible, the single-shot ``L.dense_apply`` otherwise."""
    if isinstance(p, AnalogState) and x.dim() == 3 and x.shape[1] > 1:
        from repro_torch.recurrent.temporal import (temporal_dense_apply,
                                                    temporal_eligible)
        if temporal_eligible(p.meta.cfg):
            s = x.shape[1]
            tc = min(chunk, s)
            while s % tc:         # largest divisor of S <= the SSD chunk
                tc -= 1
            y = temporal_dense_apply(p, x.transpose(0, 1), key,
                                     time_chunk=tc)
            return y.transpose(0, 1).to(x.dtype)
    return L.dense_apply(p, x, key=key)


def _split_proj(proj: Tensor, cfg: ModelConfig):
    """``(z, x, B, C, dt)`` of the fused input projection."""
    d_in, h, _, n = dims(cfg)
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None):
    """Depthwise causal conv; x (B, S, C), w (K, C).  Returns ``(y,
    new_state)``, the state the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, -(k - 1):]


def _ssd_chunked(xh: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                 c: Tensor, d_skip: Tensor, chunk: int,
                 state0: Optional[Tensor] = None):
    """Chunked SSD scan.

    xh (B, S, H, P), dt (B, S, H) [post-softplus], b/c (B, S, N), d_skip
    (H,).  Returns y (B, S, H, P) float32 and the final state (B, H, P, N).
    """
    bsz, s, h, p_dim = xh.shape
    n = b.shape[-1]
    q = min(chunk, s)
    s_pad = -(-s // q) * q

    def padt(t):
        t = t.to(torch.float32)
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_pad - s))

    xh_, dt_, b_, c_ = map(padt, (xh, dt, b, c))
    a = -torch.exp(a_log)                                  # (H,) negative
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    state = (torch.zeros((bsz, h, p_dim, n), dtype=torch.float32,
                         device=xh.device)
             if state0 is None else state0.to(torch.float32))
    ys = []
    for c0 in range(0, s_pad, q):
        xc, dtc = xh_[:, c0:c0 + q], dt_[:, c0:c0 + q]
        bc, cc = b_[:, c0:c0 + q], c_[:, c0:c0 + q]
        log_a = dtc * a[None, None, :]                     # (B,Q,H) <= 0
        cum = torch.cumsum(log_a, dim=1)                   # inclusive
        total = cum[:, -1]                                 # (B,H)
        # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i.B_j)
        # x_j; the exponent is masked before exp (exp of a masked large
        # value is inf), by a Python scalar: no host copy inside a capture
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B,Qi,Qj,H)
        decay = torch.exp(torch.where(mask, diff, -1e30))
        cb = torch.einsum("bin,bjn->bij", cc, bc)          # (B,Qi,Qj)
        w_ij = cb[..., None] * decay * dtc[:, None, :, :]  # (B,Qi,Qj,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w_ij, xc)
        # inter-chunk: y_i += (C_i . state) * exp(cum_i)
        y_inter = torch.einsum("bin,bhpn->bihp", cc, state) \
            * torch.exp(cum)[:, :, :, None]
        # state = exp(total) state + sum_j exp(total - cum_j) dt_j
        #                                  (x_j (x) B_j)
        w_j = torch.exp(total[:, None, :] - cum) * dtc     # (B,Q,H)
        ds = torch.einsum("bjh,bjhp,bjn->bhpn", w_j, xc, bc)
        state = torch.exp(total)[:, :, None, None] * state + ds
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + d_skip[None, None, :, None] * xh.to(torch.float32)
    return y, state


def forward(p, x: Tensor, cfg: ModelConfig, akey=None,
            state: Optional[Dict[str, Tensor]] = None,
            return_state: bool = False):
    """Full-sequence SSD forward.  x (B, S, d) -> (B, S, d); with
    ``state`` ({conv, ssm}) the sequence continues from it."""
    d_in, h, p_dim, n = dims(cfg)
    k = None if akey is None else prng.fold_in(akey, 0)
    proj = _seq_dense(p["in_proj"], x, k, cfg.ssm.chunk)
    z, xs, b, c, dt = _split_proj(proj, cfg)

    xbc = torch.cat([xs, b, c], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(xbc.dtype), conv_state)
    xbc = F.silu(xbc)
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)

    dt = dt.to(torch.float32) + p["dt_bias"][None, None, :]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus
    xh = xs.reshape(*xs.shape[:-1], h, p_dim)
    ssm_state = None if state is None else state["ssm"]
    y, new_state = _ssd_chunked(xh, dt, p["A_log"], b, c, p["D"],
                                cfg.ssm.chunk, ssm_state)
    y = y.reshape(*x.shape[:-1], d_in).to(x.dtype)
    y = L.rmsnorm_apply(p["norm"], y, cfg.norm_eps) * F.silu(z)
    k2 = None if akey is None else prng.fold_in(akey, 1)
    out = _seq_dense(p["out_proj"], y, k2, cfg.ssm.chunk)
    if return_state:
        return out, {"conv": new_conv, "ssm": new_state}
    return out


def decode(p, x_t: Tensor, state: Dict[str, Tensor], cfg: ModelConfig,
           akey=None):
    """Single-token recurrent step; state {conv (B, K-1, C), ssm (B, H, P,
    N)}.  Returns ``(y, new_state)``."""
    return forward(p, x_t, cfg, akey=akey, state=state, return_state=True)


def init_state(cfg: ModelConfig, batch: int, device="cuda"):
    d_in, h, p_dim, n = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_in + 2 * n),
                            dtype=cfg.act_dtype, device=device),
        "ssm": torch.zeros((batch, h, p_dim, n), dtype=torch.float32,
                           device=device),
    }
