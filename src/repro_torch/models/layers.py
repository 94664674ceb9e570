"""Shared model layers on plain tensors and parameter dicts.

Analog integration is parameter-typed: ``dense_apply`` dispatches on
whether it holds a plain ``{"w"[, "b"]}`` dict or an
:class:`~repro_torch.analog.modules.AnalogState` tile (produced by
``repro_torch.analog.convert.convert_to_analog``).  Analog reads run in
float32 and cast back to the activation dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.analog.modules import AnalogLinear, AnalogState

Tensor = torch.Tensor
Params = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype,
                          device) -> Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], drawn from ``gen``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t.mul_(scale).to(dtype)


# --- dense -------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> Params:
    """Weight ``(d_in, d_out)``.  It is drawn as a contiguous ``(d_out,
    d_in)`` tensor and exposed transposed, so an analog tile (physical
    layout ``(out, in)``) takes it over without a copy."""
    scale = scale if scale is not None else d_in ** -0.5
    w = truncated_normal_init(gen, (d_out, d_in), scale, dtype, device)
    return {"w": w.T}


def dense_apply(p: Params, x: Tensor, *, key=None, lr=1.0) -> Tensor:
    """``x @ w (+ b)``, or the analog tile's read; ``lr`` sets an analog
    tile's pulse gains in its update cycle."""
    if isinstance(p, AnalogState):
        return AnalogLinear.apply(p, x.to(torch.float32), key,
                                  lr=lr).to(x.dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# --- norms -------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm_apply(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# --- rotary position embedding -------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D) or (..., S, D); positions broadcastable (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = (1.0 / theta) ** (np.arange(0, half, dtype=np.float32) / half)
    freqs = torch.from_numpy(freqs).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    if x.dim() == ang.dim() + 1:                            # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- embeddings ---------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> Params:
    # GPT-style 0.02 scale
    return {"table": truncated_normal_init(gen, (vocab, d), 0.02, dtype,
                                           device)}


def embed_apply(p: Params, tokens: Tensor) -> Tensor:
    return p["table"][tokens]
