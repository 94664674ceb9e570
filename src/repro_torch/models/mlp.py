"""SwiGLU MLP block (the dense FFN)."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils import prng

Tensor = torch.Tensor


def init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    mk = lambda d_in, d_out: L.dense_init(gen, d_in, d_out, cfg.param_dtype,
                                          device)
    return {"wi": mk(d, f), "wg": mk(d, f), "wo": mk(f, d)}


def apply(p, x: Tensor, cfg: ModelConfig, akey=None) -> Tensor:
    # one batched split(akey, 3) for the three dense reads (wg, wi, wo)
    ks = None if akey is None else prng.split(akey, 3)

    def dense(name, xx, i):
        return L.dense_apply(p[name], xx, key=None if ks is None else ks[i])

    h = F.silu(dense("wg", x, 0)) * dense("wi", x, 1)
    return dense("wo", h, 2)
