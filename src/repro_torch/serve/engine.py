"""Serving engine: prefill + batched greedy decode with per-layer KV caches.

Analog serving: parameters converted by ``convert_to_analog`` dispatch
through ``dense_apply``; pass ``akey`` and every analog projection draws its
read keys from the JAX package's schedule — per layer ``fold_in(akey, li)``,
unembed ``fold_in(akey, 203)``, decode step ``i`` from
``decode_step_key(akey, i)``.

Caches are dicts of tensors stacked over layers (leading L axis) plus the
per-row position ``pos``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils import prng

Tensor = torch.Tensor

#: fold_in offset separating decode-step keys from the per-layer (li) and
#: unembed (203) constants consumed from the same base key.
DECODE_KEY_OFFSET = 1 << 20
UNEMBED_KEY = 203


def decode_step_key(akey, step: int):
    """Per-decode-step analog key ``fold_in(akey, OFFSET + step)``; None
    passes through so digital callers stay key-free."""
    if akey is None:
        return None
    return prng.fold_in(akey, DECODE_KEY_OFFSET + step)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Tensor]:
    """Zero-initialised decode state."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int64, device=device)}


def _unembed(params, x: Tensor, akey) -> Tensor:
    uk = None if akey is None else prng.fold_in(akey, UNEMBED_KEY)
    return L.dense_apply(params["unembed"], x, key=uk)


def prefill(params, tokens: Tensor, cfg: ModelConfig, *, max_seq: int,
            akey=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Process the prompt; returns (last-position logits, decode cache)."""
    x = L.embed_apply(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    ks, vs = [], []
    for li, layer_p in enumerate(params["layers"]):
        lk = None if akey is None else prng.fold_in(akey, li)
        x, cache = T.block_prefill(layer_p, x, cfg, positions=positions,
                                   cache_len=max_seq, akey=lk)
        ks.append(cache["k"])
        vs.append(cache["v"])
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, x[:, -1:], akey)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs),
              "pos": torch.full((tokens.shape[0],), tokens.shape[1],
                                dtype=torch.int64, device=tokens.device)}
    return logits, caches


def serve_step(params, tokens_t: Tensor, cache: Dict[str, Tensor],
               cfg: ModelConfig, akey=None
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One batched decode step.  tokens_t (B, 1) -> (logits (B,1,V), cache)."""
    pos = cache["pos"]
    x = L.embed_apply(params["embed"], tokens_t)
    ks, vs = [], []
    for li, layer_p in enumerate(params["layers"]):
        lk = None if akey is None else prng.fold_in(akey, li)
        x, nc = T.block_decode(layer_p, x,
                               {"k": cache["k"][li], "v": cache["v"][li]},
                               pos, cfg, akey=lk)
        ks.append(nc["k"])
        vs.append(nc["v"])
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, x, akey)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": pos + 1}


def greedy_generate(params, prompt: Tensor, cfg: ModelConfig, *,
                    n_steps: int, max_seq: int, akey=None):
    """Batched greedy loop: prefill with the base key, then decode step
    ``i`` with ``decode_step_key(akey, i)``.  Returns (tokens (B, n_steps),
    cache)."""
    logits, cache = prefill(params, prompt, cfg, max_seq=max_seq, akey=akey)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks = [tok]
    for i in range(n_steps - 1):
        logits, cache = serve_step(params, tok, cache, cfg,
                                   akey=decode_step_key(akey, i))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), cache
