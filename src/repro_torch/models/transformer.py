"""Dense decoder stack: pre-norm residual blocks of [attention + SwiGLU],
RMSNorm, RoPE, untied unembedding.

Parameters are plain dicts; the layers of the stack are a Python list of
per-layer dicts walked by a Python loop (the JAX package scans over stacked
layers).  Analog mode threads a per-layer key ``fold_in(akey, layer)``
through every projection.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers as L, mlp
from repro_torch.utils import prng

Tensor = torch.Tensor
Params = Dict[str, Any]


def _block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {
        "ln_attn": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
        "attn": attention.init(gen, cfg, device),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
        "mlp": mlp.init(gen, cfg, device),
    }


def init_lm(seed: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random parameters drawn from ``seed`` on ``device``.

    Matched dense sites (slash-joined paths like ``layers/attn/q``) are
    converted to analog tiles under the config's policy, with the JAX
    package's conversion key (the sixth key of ``split(key(seed), 6)``),
    so tile seeds agree between the packages.  Weight values come from a
    ``torch.Generator`` and differ from the JAX package's.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                              device),
        "layers": [_block_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype,
                                device),
    }
    if cfg.analog_policy is not None:
        from repro_torch.analog.convert import convert_to_analog
        from repro_torch.core.device import RPUConfig
        p = convert_to_analog(p, cfg.analog_policy, key=prng.split(prng.key(seed), 6)[5],
                              normalize=RPUConfig.normalized_for_lm)
    return p


def block_prefill(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                  cache_len: int, akey=None):
    """Full-sequence block that also emits its decode cache."""
    h = L.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    att, (kk, vv) = attention.forward(p["attn"], h, cfg, positions=positions,
                                      akey=akey, return_kv=True)
    pad = cache_len - kk.shape[1]
    cache = {"k": torch.nn.functional.pad(kk, (0, 0, 0, 0, 0, pad)),
             "v": torch.nn.functional.pad(vv, (0, 0, 0, 0, 0, pad))}
    x = x + att
    h = L.rmsnorm_apply(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp.apply(p["mlp"], h, cfg, akey=akey), cache


def block_decode(p, x_t: Tensor, cache: Dict[str, Tensor], pos: Tensor,
                 cfg: ModelConfig, akey=None):
    """Single-token block step; returns (y_t, new_cache)."""
    h = L.rmsnorm_apply(p["ln_attn"], x_t, cfg.norm_eps)
    att, nk, nv = attention.decode(p["attn"], h, cache["k"], cache["v"], pos,
                                   cfg, akey=akey)
    x_t = x_t + att
    h = L.rmsnorm_apply(p["ln_ffn"], x_t, cfg.norm_eps)
    return x_t + mlp.apply(p["mlp"], h, cfg, akey=akey), {"k": nk, "v": nv}
