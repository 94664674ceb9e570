"""Serving engine: prefill + batched greedy decode with per-layer caches.

Analog serving: parameters converted by ``convert_to_analog`` dispatch
through ``dense_apply``; pass ``akey`` and every analog projection draws its
read keys from the JAX package's schedule — per layer ``fold_in(akey, li)``,
an untied unembed ``fold_in(akey, 203)``, decode step ``i`` from
``decode_step_key(akey, i)``.

Caches are dicts of tensors stacked over layers (leading L axis) plus the
per-row position ``pos`` (int32, as in the JAX package): ``k``/``v`` for
attention (a ring of ``swa_window`` slots when the window is shorter than
``max_seq``; int8 codes under ``kv_cache_quant``; no KV cache for the ssm
family), ``ssm_conv`` and ``ssm_state`` for the SSD blocks, and an
encoder-decoder's static cross attention memory ``cross_k``/``cross_v``
(B, S_src, Hkv, hd), projected once by the prefill from the encoder's
output (``enc_embeds``: the stub frames) and read, never written, by every
decode step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.utils import prng

Tensor = torch.Tensor

#: fold_in offset separating decode-step keys from the per-layer (li) and
#: unembed (203) constants consumed from the same base key.
DECODE_KEY_OFFSET = 1 << 20


def decode_step_key(akey, step: int):
    """Per-decode-step analog key ``fold_in(akey, OFFSET + step)``; None
    passes through so digital callers stay key-free."""
    if akey is None:
        return None
    return prng.fold_in(akey, DECODE_KEY_OFFSET + step)


def cache_len_for(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.swa_window > 0:
        return min(cfg.swa_window, max_seq)
    return max_seq


#: The cache leaves a decode step reads and never writes.
STATIC = ("cross_k", "cross_v")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, src_len: int = 0,
               device="cuda") -> Dict[str, Tensor]:
    """Zero-initialised decode state (``src_len``: an encoder-decoder's
    source length)."""
    c: Dict[str, Tensor] = {}
    n, cl = cfg.n_layers, cache_len_for(cfg, max_seq)
    if cfg.family != "ssm":
        shape = (n, batch, cl, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if cfg.kv_cache_quant else cfg.act_dtype
        c["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        c["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.family in ("ssm", "hybrid"):
        st = S.init_state(cfg, batch, device=device)
        c["ssm_conv"] = st["conv"][None].repeat(n, 1, 1, 1)
        c["ssm_state"] = st["ssm"][None].repeat(n, 1, 1, 1, 1)
    if cfg.encoder_layers > 0:
        shape = (n, batch, src_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
    c["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return c


def _stack(caches) -> Dict[str, Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def prefill(params, tokens: Tensor, cfg: ModelConfig, *, max_seq: int,
            enc_embeds=None, akey=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Process the prompt (and an encoder-decoder's ``enc_embeds`` (B,
    S_src, d)); returns (last-position logits, decode cache)."""
    x = L.embed_apply(params["embed"], tokens)
    enc_out = (T.encode(params, enc_embeds, cfg, x.dtype, akey)
               if cfg.encoder_layers > 0 else None)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    cl = cache_len_for(cfg, max_seq)
    caches = []
    for li, layer_p in enumerate(params["layers"]):
        lk = None if akey is None else prng.fold_in(akey, li)
        x, cache = T.block_prefill(layer_p, x, cfg, positions=positions,
                                   cache_len=cl, enc_out=enc_out, akey=lk)
        caches.append(cache)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = T.unembed(params, x[:, -1:], cfg, akey)
    caches = _stack(caches)
    caches["pos"] = torch.full((tokens.shape[0],), tokens.shape[1],
                               dtype=torch.int32, device=tokens.device)
    return logits, caches


def serve_step(params, tokens_t: Tensor, cache: Dict[str, Tensor],
               cfg: ModelConfig, akey=None
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One batched decode step.  tokens_t (B, 1) -> (logits (B,1,V), cache)."""
    pos = cache["pos"]
    x = L.embed_apply(params["embed"], tokens_t)
    names = [k for k in cache if k != "pos"]
    caches = []
    for li, layer_p in enumerate(params["layers"]):
        lk = None if akey is None else prng.fold_in(akey, li)
        x, nc = T.block_decode(layer_p, x, {k: cache[k][li] for k in names},
                               pos, cfg, akey=lk)
        caches.append(nc)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = T.unembed(params, x, cfg, akey)
    new_cache = _stack([{k: v for k, v in c.items() if k not in STATIC}
                        for c in caches])
    new_cache.update({k: cache[k] for k in STATIC if k in cache})
    new_cache["pos"] = pos + 1
    return logits, new_cache


def greedy_generate(params, prompt: Tensor, cfg: ModelConfig, *,
                    n_steps: int, max_seq: int, enc_embeds=None, akey=None):
    """Batched greedy loop: prefill with the base key, then decode step
    ``i`` with ``decode_step_key(akey, i)``.  Returns (tokens (B, n_steps),
    cache).  A per-request run of it is the continuous-batching
    scheduler's token oracle (``serve/scheduler.py``)."""
    logits, cache = prefill(params, prompt, cfg, max_seq=max_seq,
                            enc_embeds=enc_embeds, akey=akey)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks = [tok]
    for i in range(n_steps - 1):
        logits, cache = serve_step(params, tok, cache, cfg,
                                   akey=decode_step_key(akey, i))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), cache
