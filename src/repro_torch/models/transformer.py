"""Dense decoder stack: pre-norm residual blocks of [attention + SwiGLU],
RMSNorm, RoPE, untied unembedding.

Parameters are plain dicts; the layers of the stack are a Python list of
per-layer dicts walked by a Python loop (the JAX package scans over stacked
layers).  Analog mode threads a per-layer key ``fold_in(akey, layer)``
through every projection, and ``fold_in(akey, 203)`` through the unembed.

:func:`forward` is the training forward (``transformer.py:65-235`` of the
JAX package: ``_block_apply``, ``_scan_layers``, ``forward``).  With
``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (the
non-reentrant form): the backward recomputes the block's forward, analog
reads included, from the same keys, so the recompute changes no bit; each
tile's update still runs once, in its read's backward.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

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


def _jax_draws(seed: int, cfg: ModelConfig, device) -> Params:
    """The JAX package's ``init_lm`` weights for ``key(seed)``: its key
    tree (``split(key, 6)``; per layer ``split(split(k1, L)[l], 8)``, q, k,
    v, o from ``split(., 4)`` of the first, wi, wg, wo from ``split(., 3)``
    of the fourth), each weight ``scale * truncated_normal(-2, 2)`` drawn
    on the host (``prng.truncated_normal``, within 3 ulp of JAX's)."""
    def tn(k, shape, scale):
        z = np.float32(scale) * prng.truncated_normal(k, -2.0, 2.0, shape)
        return torch.from_numpy(z).to(device=device, dtype=cfg.param_dtype)

    def dense(k, d_in, d_out):
        # drawn (d_in, d_out) as JAX draws it, held as a contiguous
        # (d_out, d_in) tensor exposed transposed (``L.dense_init``)
        return {"w": tn(k, (d_in, d_out), d_in ** -0.5).T.contiguous().T}

    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    ks = prng.split(prng.key(seed), 6)
    layers = []
    for lk in prng.split(ks[1], cfg.n_layers):
        kb = prng.split(lk, 8)
        ka, km = prng.split(kb[0], 4), prng.split(kb[3], 3)
        attn = {"q": dense(ka[0], d, h * hd), "k": dense(ka[1], d, hkv * hd),
                "v": dense(ka[2], d, hkv * hd), "o": dense(ka[3], h * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"] = L.rmsnorm_init(hd, cfg.param_dtype, device)
            attn["k_norm"] = L.rmsnorm_init(hd, cfg.param_dtype, device)
        layers.append({
            "ln_attn": L.rmsnorm_init(d, cfg.param_dtype, device),
            "attn": attn,
            "ln_ffn": L.rmsnorm_init(d, cfg.param_dtype, device),
            "mlp": {"wi": dense(km[0], d, f), "wg": dense(km[1], d, f),
                    "wo": dense(km[2], f, d)}})
    return {"embed": {"table": tn(ks[0], (cfg.vocab, d), 0.02)},
            "layers": layers,
            "final_norm": L.rmsnorm_init(d, cfg.param_dtype, device),
            "unembed": dense(ks[4], d, cfg.vocab)}


def init_lm(seed: int, cfg: ModelConfig, device="cuda",
            jax_weights: bool = False) -> Params:
    """Random parameters drawn from ``seed`` on ``device``.

    Matched dense sites (slash-joined paths like ``layers/attn/q``) are
    converted to analog tiles under the config's policy, with the JAX
    package's conversion key (the sixth key of ``split(key(seed), 6)``),
    so tile seeds agree between the packages.  Weight values come from a
    ``torch.Generator`` on ``device`` and differ from the JAX package's;
    with ``jax_weights`` they are the JAX package's draws (made on the
    host: for small configs).
    """
    if jax_weights:
        p = _jax_draws(seed, cfg, device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        p = {
            "embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                  cfg.param_dtype, device),
            "layers": [_block_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)],
            "final_norm": L.rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                         device),
            "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab,
                                    cfg.param_dtype, device),
        }
    policy = cfg.resolved_analog_policy()
    if policy is not None:
        from repro_torch.analog.convert import convert_to_analog
        from repro_torch.core.device import RPUConfig
        p = convert_to_analog(p, policy, key=prng.split(prng.key(seed), 6)[5],
                              normalize=RPUConfig.normalized_for_lm)
    return p


def _block_apply(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                 akey=None) -> Tensor:
    """Full-sequence block (the dense family's aux loss is zero)."""
    h = L.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    x = x + attention.forward(p["attn"], h, cfg, positions=positions,
                              akey=akey)
    h = L.rmsnorm_apply(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp.apply(p["mlp"], h, cfg, akey=akey)


def _layers(layers, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
            akey=None) -> Tensor:
    """The layer loop: layer ``li`` under ``fold_in(akey, li)``, each block
    recomputed in the backward under ``cfg.remat``."""
    if cfg.remat and cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' saves the projection outputs through an "
            "XLA checkpoint policy with no PyTorch counterpart that saves "
            "the same values (ROADMAP Queue 1); use 'full'")
    for li, layer_p in enumerate(layers):
        lk = None if akey is None else prng.fold_in(akey, li)
        block = lambda xx, p=layer_p, k=lk: _block_apply(  # noqa: E731
            p, xx, cfg, positions=positions, akey=k)
        if cfg.remat and torch.is_grad_enabled():
            # the reads draw no torch RNG: nothing to stash for the
            # recompute
            x = torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x)
    return x


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            akey=None) -> Tuple[Tensor, Tensor]:
    """Training forward -> ``(logits, aux)``; ``tokens`` (B, S), ``aux`` a
    0-d float32 zero (the dense family has no auxiliary loss)."""
    x = L.embed_apply(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x = _layers(params["layers"], x, cfg, positions=positions, akey=akey)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    uk = None if akey is None else prng.fold_in(akey, 203)
    logits = L.dense_apply(params["unembed"], x, key=uk)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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
