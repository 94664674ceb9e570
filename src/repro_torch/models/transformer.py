"""Decoder stacks by family: pre-norm residual blocks, RMSNorm, RoPE.

  dense  : [attn + SwiGLU]
  ssm    : [SSD]                      (mamba2: no attention, no MLP)
  hybrid : [attn || SSD  + SwiGLU]    (hymba: parallel heads, averaged)
  audio  : encoder [bi-attn + SwiGLU] + decoder [self-attn + cross-attn
           + SwiGLU]                  (seamless: stub frames through an
                                       adapter into the encoder)

The unembedding is its own projection, or the embedding table with
``tie_embeddings`` (mamba2).

Parameters are plain dicts; the layers of the stack are a Python list of
per-layer dicts walked by a Python loop (the JAX package scans over stacked
layers).  Analog mode threads a per-layer key ``fold_in(akey, layer)``
through every projection, and ``fold_in(akey, 203)`` through an untied
unembed.  The encoder's layers read under ``fold_in(akey, 1000 + li)``,
the adapter under ``fold_in(akey, 202)`` and a decoder block's cross
attention under ``fold_in(layer key, 102)``.  A hybrid block's SSD branch
reads under ``fold_in(akey, 101)``
in ``_block_apply`` and ``block_decode``, but under the layer key itself
in ``block_prefill``, where its ``in_proj`` read shares the attention's q
key: the JAX package's keys, copied as they are.

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
from repro_torch.models import attention, layers as L, mlp, ssm
from repro_torch.utils import prng

Tensor = torch.Tensor
Params = Dict[str, Any]


def _block_init(gen: torch.Generator, cfg: ModelConfig, device, *,
                cross: bool = False) -> Params:
    p: Params = {}
    if cfg.family != "ssm":
        p["ln_attn"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device)
        p["attn"] = attention.init(gen, cfg, device)
    if cross:
        p["ln_cross"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device)
        p["cross"] = attention.init(gen, cfg, device, cross=True)
    if cfg.family in ("ssm", "hybrid"):
        p["ln_ssm"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device)
        p["ssm"] = ssm.init(gen, cfg, device)
    if cfg.family != "ssm":
        p["ln_ffn"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device)
        p["mlp"] = mlp.init(gen, cfg, device)
    return p


def _jax_draws(seed: int, cfg: ModelConfig, device) -> Params:
    """The JAX package's ``init_lm`` weights for ``key(seed)``: its key
    tree (``split(key, 6)``; per layer ``split(split(k1, L)[l], 8)``: q, k,
    v, o from ``split(., 4)`` of the first (the cross attention's of the
    second; QKV biases zeros, from no key), the SSD block's from
    ``split(., 6)`` of the third, wi, wg, wo from ``split(., 3)`` of the
    fourth; the encoder's layers the same from ``split(k2, L_enc)``, the
    adapter from k3), each
    weight ``scale * truncated_normal(-2, 2)`` drawn on the host
    (``prng.truncated_normal``, within 3 ulp of JAX's)."""
    def tn(k, shape, scale):
        z = np.float32(scale) * prng.truncated_normal(k, -2.0, 2.0, shape)
        return torch.from_numpy(z).to(device=device, dtype=cfg.param_dtype)

    def dense(k, d_in, d_out):
        # drawn (d_in, d_out) as JAX draws it, held as a contiguous
        # (d_out, d_in) tensor exposed transposed (``L.dense_init``)
        return {"w": tn(k, (d_in, d_out), d_in ** -0.5).T.contiguous().T}

    def norm(d):
        return L.rmsnorm_init(d, cfg.param_dtype, device)

    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)

    def attn(k):
        ka = prng.split(k, 4)
        a = {"q": dense(ka[0], d, h * hd), "k": dense(ka[1], d, hkv * hd),
             "v": dense(ka[2], d, hkv * hd), "o": dense(ka[3], h * hd, d)}
        if cfg.qkv_bias:
            a.update(attention.bias_init(cfg, device))
        if cfg.qk_norm:
            a["q_norm"], a["k_norm"] = norm(hd), norm(hd)
        return a

    def block(lk, cross):
        kb = prng.split(lk, 8)
        layer: Params = {}
        if cfg.family != "ssm":
            layer.update(ln_attn=norm(d), attn=attn(kb[0]))
        if cross:
            layer.update(ln_cross=norm(d), cross=attn(kb[1]))
        if cfg.family in ("ssm", "hybrid"):
            d_in, nh, _, n = ssm.dims(cfg)
            conv_ch = d_in + 2 * n
            kss = prng.split(kb[2], 6)
            layer.update(ln_ssm=norm(d), ssm={
                "in_proj": dense(kss[0], d, 2 * d_in + 2 * n + nh),
                "out_proj": dense(kss[1], d_in, d),
                "conv_w": tn(kss[2], (cfg.ssm.d_conv, conv_ch),
                             conv_ch ** -0.5),
                "A_log": ssm.a_log_init(nh, device),
                "D": torch.ones(nh, dtype=torch.float32, device=device),
                "dt_bias": torch.zeros(nh, dtype=torch.float32,
                                       device=device),
                "norm": norm(d_in)})
        if cfg.family != "ssm":
            km = prng.split(kb[3], 3)
            layer.update(ln_ffn=norm(d), mlp={
                "wi": dense(km[0], d, f), "wg": dense(km[1], d, f),
                "wo": dense(km[2], f, d)})
        return layer

    ks = prng.split(prng.key(seed), 6)
    cross = cfg.encoder_layers > 0
    p = {"embed": {"table": tn(ks[0], (cfg.vocab, d), 0.02)},
         "layers": [block(lk, cross)
                    for lk in prng.split(ks[1], cfg.n_layers)]}
    if cross:
        p["enc_layers"] = [block(lk, False) for lk in
                           prng.split(ks[2], cfg.encoder_layers)]
        p["enc_norm"] = norm(d)
    if cfg.frontend != "none":
        p["adapter"] = dense(ks[3], d, d)
    p["final_norm"] = norm(d)
    if not cfg.tie_embeddings:
        p["unembed"] = dense(ks[4], d, cfg.vocab)
    return p


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
        cross = cfg.encoder_layers > 0
        p = {
            "embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                  cfg.param_dtype, device),
            "layers": [_block_init(gen, cfg, device, cross=cross)
                       for _ in range(cfg.n_layers)],
        }
        if cross:
            p["enc_layers"] = [_block_init(gen, cfg, device)
                               for _ in range(cfg.encoder_layers)]
            p["enc_norm"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                           device)
        if cfg.frontend != "none":
            p["adapter"] = L.dense_init(gen, cfg.d_model, cfg.d_model,
                                        cfg.param_dtype, device)
        p["final_norm"] = L.rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                         device)
        if not cfg.tie_embeddings:
            p["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab,
                                        cfg.param_dtype, device)
    policy = cfg.resolved_analog_policy()
    if policy is not None:
        from repro_torch.analog.convert import convert_to_analog
        from repro_torch.core.device import RPUConfig
        p = convert_to_analog(p, policy, key=prng.split(prng.key(seed), 6)[5],
                              normalize=RPUConfig.normalized_for_lm)
    return p


def _hybrid_key(akey):
    return None if akey is None else prng.fold_in(akey, 101)


def _cross_key(akey):
    return None if akey is None else prng.fold_in(akey, 102)


def _block_apply(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                 causal: bool = True, enc_out=None, akey=None) -> Tensor:
    """Full-sequence block (no family here has an aux loss); ``enc_out``
    (B, S_src, d) adds the decoder's cross attention."""
    if cfg.family == "ssm":
        h = L.rmsnorm_apply(p["ln_ssm"], x, cfg.norm_eps)
        return x + ssm.forward(p["ssm"], h, cfg, akey=akey)
    h = L.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    att = attention.forward(p["attn"], h, cfg, positions=positions,
                            causal=causal, akey=akey)
    if cfg.family == "hybrid":
        hs = L.rmsnorm_apply(p["ln_ssm"], x, cfg.norm_eps)
        sout = ssm.forward(p["ssm"], hs, cfg, akey=_hybrid_key(akey))
        att = 0.5 * (att + sout)          # hymba: parallel heads, averaged
    x = x + att
    if enc_out is not None:
        h = L.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + attention.forward(p["cross"], h, cfg, positions=positions,
                                  causal=False, x_kv=enc_out,
                                  akey=_cross_key(akey))
    h = L.rmsnorm_apply(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp.apply(p["mlp"], h, cfg, akey=akey)


def _layers(layers, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
            causal: bool = True, enc_out=None, akey=None,
            key_base: int = 0) -> Tensor:
    """The layer loop: layer ``li`` under ``fold_in(akey, key_base + li)``,
    each block recomputed in the backward under ``cfg.remat``."""
    if cfg.remat and cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' saves the projection outputs through an "
            "XLA checkpoint policy with no PyTorch counterpart that saves "
            "the same values (ROADMAP Queue 1); use 'full'")
    for li, layer_p in enumerate(layers):
        lk = None if akey is None else prng.fold_in(akey, key_base + li)
        block = lambda xx, p=layer_p, k=lk: _block_apply(  # noqa: E731
            p, xx, cfg, positions=positions, causal=causal,
            enc_out=enc_out, akey=k)
        if cfg.remat and torch.is_grad_enabled():
            # the reads draw no torch RNG: nothing to stash for the
            # recompute
            x = torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x)
    return x


def encode(params: Params, enc_embeds: Tensor, cfg: ModelConfig, dtype,
           akey=None) -> Tensor:
    """The encoder's output (B, S_src, d): the stub frames ``enc_embeds``
    in ``dtype`` through the adapter (key ``fold_in(akey, 202)``), the
    bidirectional layers (``fold_in(akey, 1000 + li)``) and ``enc_norm``."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         "enc_embeds (B, S_src, d_model)")
    e = enc_embeds.to(dtype)
    if "adapter" in params:
        ek = None if akey is None else prng.fold_in(akey, 202)
        e = L.dense_apply(params["adapter"], e, key=ek)
    e_pos = torch.arange(e.shape[1], device=e.device)[None]
    e = _layers(params["enc_layers"], e, cfg, positions=e_pos,
                causal=False, akey=akey, key_base=1000)
    return L.rmsnorm_apply(params["enc_norm"], e, cfg.norm_eps)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            enc_embeds=None, akey=None) -> Tuple[Tensor, Tensor]:
    """Training forward -> ``(logits, aux)``; ``tokens`` (B, S), ``aux`` a
    0-d float32 zero (no family here has an auxiliary loss);
    ``enc_embeds`` (B, S_src, d) feed an encoder-decoder's encoder."""
    x = L.embed_apply(params["embed"], tokens)
    enc_out = (encode(params, enc_embeds, cfg, x.dtype, akey)
               if cfg.encoder_layers > 0 else None)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x = _layers(params["layers"], x, cfg, positions=positions,
                enc_out=enc_out, akey=akey)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return (unembed(params, x, cfg, akey),
            torch.zeros((), dtype=torch.float32, device=x.device))


def unembed(params: Params, x: Tensor, cfg: ModelConfig, akey=None):
    """Logits: the tied table, or the unembed read under ``fold_in(akey,
    203)``."""
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], x)
    uk = None if akey is None else prng.fold_in(akey, 203)
    return L.dense_apply(params["unembed"], x, key=uk)


def _ring_cache_from_full(k: Tensor, window: int) -> Tensor:
    """The last ``window`` keys of (B, S, H, D) in ring-slot order."""
    s = k.shape[1]
    if s <= window:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, window - s))
    idx = torch.arange(s - window, s, device=k.device)
    out = torch.zeros((k.shape[0], window, *k.shape[2:]), dtype=k.dtype,
                      device=k.device)
    out[:, idx % window] = k[:, idx]
    return out


def block_prefill(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                  cache_len: int, enc_out=None, akey=None):
    """Full-sequence block that also emits its decode cache (with
    ``enc_out``, the static cross K/V ``cross_k``/``cross_v``, which stay
    in the reads' dtype under ``kv_cache_quant``)."""
    cache: Dict[str, Tensor] = {}
    if cfg.family != "ssm":
        h = L.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
        att, (kk, vv) = attention.forward(p["attn"], h, cfg,
                                          positions=positions, akey=akey,
                                          return_kv=True)
        if cfg.kv_cache_quant:
            kk, vv = attention.quantize_kv(kk), attention.quantize_kv(vv)
        if cfg.swa_window > 0:
            w = min(cfg.swa_window, cache_len)
            cache["k"] = _ring_cache_from_full(kk, w)
            cache["v"] = _ring_cache_from_full(vv, w)
        else:
            pad = (0, 0, 0, 0, 0, cache_len - kk.shape[1])
            cache["k"] = torch.nn.functional.pad(kk, pad)
            cache["v"] = torch.nn.functional.pad(vv, pad)
    if cfg.family in ("ssm", "hybrid"):
        hs = L.rmsnorm_apply(p["ln_ssm"], x, cfg.norm_eps)
        # the layer key itself, also for the hybrid (see the module doc)
        sout, st = ssm.forward(p["ssm"], hs, cfg, akey=akey,
                               return_state=True)
        cache["ssm_conv"], cache["ssm_state"] = st["conv"], st["ssm"]
    if cfg.family == "ssm":
        return x + sout, cache
    if cfg.family == "hybrid":
        att = 0.5 * (att + sout)
    x = x + att
    if enc_out is not None:
        # the cross attention's memory, projected once
        h = L.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        y, (cache["cross_k"], cache["cross_v"]) = attention.forward(
            p["cross"], h, cfg, positions=positions, causal=False,
            x_kv=enc_out, akey=_cross_key(akey), return_kv=True)
        x = x + y
    h = L.rmsnorm_apply(p["ln_ffn"], x, cfg.norm_eps)
    return x + mlp.apply(p["mlp"], h, cfg, akey=akey), cache


def block_decode(p, x_t: Tensor, cache: Dict[str, Tensor], pos: Tensor,
                 cfg: ModelConfig, akey=None):
    """Single-token block step; returns (y_t, new_cache)."""
    new_cache = dict(cache)

    def ssm_step(key):
        h = L.rmsnorm_apply(p["ln_ssm"], x_t, cfg.norm_eps)
        sout, st = ssm.decode(p["ssm"], h, {"conv": cache["ssm_conv"],
                                            "ssm": cache["ssm_state"]},
                              cfg, akey=key)
        new_cache["ssm_conv"], new_cache["ssm_state"] = st["conv"], st["ssm"]
        return sout

    if cfg.family == "ssm":
        return x_t + ssm_step(akey), new_cache
    h = L.rmsnorm_apply(p["ln_attn"], x_t, cfg.norm_eps)
    att, new_cache["k"], new_cache["v"] = attention.decode(
        p["attn"], h, cache["k"], cache["v"], pos, cfg, akey=akey)
    if cfg.family == "hybrid":
        att = 0.5 * (att + ssm_step(_hybrid_key(akey)))
    x_t = x_t + att
    if "cross_k" in cache:
        h = L.rmsnorm_apply(p["ln_cross"], x_t, cfg.norm_eps)
        yc, _, _ = attention.decode(p["cross"], h, cache["cross_k"],
                                    cache["cross_v"], pos, cfg, cross=True,
                                    akey=_cross_key(akey))
        x_t = x_t + yc
    h = L.rmsnorm_apply(p["ln_ffn"], x_t, cfg.norm_eps)
    return x_t + mlp.apply(p["mlp"], h, cfg, akey=akey), new_cache
