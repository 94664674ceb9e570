"""Grouped-query attention with optional QKV bias (qwen1.5), qk RMS-norm
(qwen3) and a sliding window (hymba): online-softmax prefill and
single-token decode over a KV cache, a ring buffer of ``swa_window`` slots
when the cache holds exactly that many, int8 under ``kv_cache_quant``
(:func:`quantize_kv`: ``round(16 x)`` clipped to +-127, dequantized to
q's dtype before the scores).  Bidirectional (``causal=False``:
seamless's encoder) and cross attention (``x_kv``: the decoder over the
encoder's output, no RoPE; its decode reads the static cross K/V and
writes nothing) as in the JAX package.

The projections go through ``layers.dense_apply``, so an analog policy
turns them into managed array reads; their read keys are
``fold_in(akey, 0/1/2)`` for q/k/v and ``fold_in(akey, 3)`` for o, as in the
JAX package.  Prefill attention is the flash-attention kernel
(``kernels/flash_attention.py``) when ``cfg.use_flash_kernel`` is set, else
the plain-PyTorch chunked online-softmax loop (the JAX package's ``_flash``
fallback).  Decode is einsum + softmax over the cache.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.utils import prng

Tensor = torch.Tensor

NEG_INF = -1e30


def init(gen: torch.Generator, cfg: ModelConfig, device, *,
         cross: bool = False) -> Dict[str, Any]:
    """QKVO projection params (digital; analog conversion is policy-driven).
    A cross attention's (``cross``) are the same four projections."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mk = lambda d_in, d_out: L.dense_init(gen, d_in, d_out, cfg.param_dtype,
                                          device)
    p = {"q": mk(d, h * hd), "k": mk(d, hkv * hd), "v": mk(d, hkv * hd),
         "o": mk(h * hd, d)}
    if cfg.qkv_bias:
        p.update(bias_init(cfg, device))
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, cfg.param_dtype, device)
        p["k_norm"] = L.rmsnorm_init(hd, cfg.param_dtype, device)
    return p


def bias_init(cfg: ModelConfig, device) -> Dict[str, Tensor]:
    """The zero QKV biases ``qb``, ``kb``, ``vb`` (they draw no key)."""
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {n: torch.zeros(w, dtype=cfg.param_dtype, device=device)
            for n, w in (("qb", hq), ("kb", hkv), ("vb", hkv))}


def _dense(p, name: str, x: Tensor, cfg: ModelConfig, akey, i: int):
    """The projection ``name`` under ``fold_in(akey, i)``, plus its QKV
    bias in the read's dtype."""
    k = None if akey is None else prng.fold_in(akey, i)
    y = L.dense_apply(p[name], x, key=k)
    if cfg.qkv_bias and name + "b" in p:
        y = y + p[name + "b"].to(y.dtype)
    return y


def _project_qkv(p, x_q: Tensor, x_kv: Tensor, cfg: ModelConfig, akey=None):
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _dense(p, "q", x_q, cfg, akey, 0).reshape(*x_q.shape[:-1], h, hd)
    k = _dense(p, "k", x_kv, cfg, akey, 1).reshape(*x_kv.shape[:-1], hkv, hd)
    v = _dense(p, "v", x_kv, cfg, akey, 2).reshape(*x_kv.shape[:-1], hkv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: int = 0,
           chunk_q: int, chunk_k: int, q_offset: int = 0) -> Tensor:
    """Online-softmax chunked attention.  q: (B, Sq, H, D); k, v: (B, Sk,
    H, D) (kv already head-repeated).  ``window > 0`` keeps keys with
    ``q - k < window``; ``q_offset`` is the absolute position of q[0]
    relative to k[0]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    scale = d ** -0.5
    qh = q.permute(0, 2, 1, 3)                  # (B, H, Sq, D)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    outs = []
    for q0 in range(0, sq, cq):
        q_blk = qh[:, :, q0:q0 + cq]
        nq = q_blk.shape[2]
        q_pos = torch.arange(nq, device=q.device) + q0 + q_offset
        m = torch.full((b, h, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros((b, h, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, nq, d), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, ck):
            k_blk, v_blk = kh[:, :, k0:k0 + ck], vh[:, :, k0:k0 + ck]
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk.float(),
                             k_blk.float()) * scale
            k_pos = torch.arange(k_blk.shape[2], device=q.device) + k0
            mask = None
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                near = q_pos[:, None] - k_pos[None, :] < window
                mask = near if mask is None else mask & near
            if mask is not None:
                s = torch.where(mask[None, None], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_ = l_ * corr + pr.sum(-1)
            # P rounds to V's dtype, the product accumulates in float32
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", pr.to(v_blk.dtype).float(),
                v_blk.float())
            m = m_new
        outs.append(acc / torch.clamp_min(l_[..., None], 1e-30))
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def forward(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
            causal: bool = True, x_kv=None, akey=None, chunk_q: int = 512,
            chunk_k: int = 512, return_kv: bool = False):
    """Attention over a full sequence (training and prefill): causal or
    bidirectional self-attention, or cross attention of ``x`` over
    ``x_kv`` (B, Sk, d), where neither side takes RoPE."""
    q, k, v = _project_qkv(p, x, x if x_kv is None else x_kv, cfg, akey)
    if x_kv is None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if cfg.use_flash_kernel:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            # the JAX package's pallas_call has no JVP rule either: its
            # training forward raises under jax.grad
            raise NotImplementedError(
                "the flash-attention kernel has no backward; train with "
                "use_flash_kernel=False (the chunked attention)")
        with torch.profiler.record_function("flash_attention"):
            out = fa.flash_attention(q, k, v, causal=causal,
                                     window=cfg.swa_window)
    else:
        n_rep = cfg.n_heads // cfg.n_kv_heads
        out = _flash(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                     causal=causal, window=cfg.swa_window, chunk_q=chunk_q,
                     chunk_k=chunk_k)
    out = out.reshape(*out.shape[:-2], cfg.n_heads * cfg.head_dim)
    okey = None if akey is None else prng.fold_in(akey, 3)
    y = L.dense_apply(p["o"], out, key=okey)
    if return_kv:
        return y, (k, v)
    return y


#: int8 KV cache: symmetric, +-8 in steps of 1/16 (the JAX package's
#: ``_KV_Q_SCALE``)
KV_Q_SCALE = 16.0


def quantize_kv(x: Tensor) -> Tensor:
    """``round(16 x)`` clipped to +-127, int8; ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x.float() * KV_Q_SCALE), -127, 127).to(
        torch.int8)


def dequantize_kv(q: Tensor, dtype) -> Tensor:
    """An int8 cache's values in ``dtype``; any other cache as it is."""
    if q.dtype == torch.int8:
        return (q.float() / KV_Q_SCALE).to(dtype)
    return q


def _scatter_time(cache: Tensor, new: Tensor, slot: Tensor) -> Tensor:
    """cache (B,S,H,D) <- new (B,1,H,D) at per-batch time index ``slot``
    (a new tensor), quantized into an int8 cache.  A one-hot write, as in
    the JAX package: a row whose slot lies past the cache (a free pool row
    decoding on) writes nothing."""
    if cache.dtype == torch.int8:
        new = quantize_kv(new)
    oh = torch.arange(cache.shape[1], device=cache.device)[None, :] \
        == slot[:, None]                                        # (B,S)
    return torch.where(oh[:, :, None, None], new.to(cache.dtype), cache)


def _ring(cfg: ModelConfig, cache: Tensor) -> bool:
    """The cache is a ring of ``swa_window`` slots (a cache shorter than
    the window, ``max_seq < swa_window``, is linear)."""
    return cfg.swa_window > 0 and cache.shape[1] == cfg.swa_window


def decode(p, x_t: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor,
           cfg: ModelConfig, *, cross: bool = False, akey=None):
    """Single-token decode.  x_t: (B, 1, d); cache_k/v: (B, S_cache, Hkv,
    hd), written at ``pos`` (a ring: at ``pos % swa_window``); with
    ``cross`` the encoder's static K/V, every slot valid, nothing written
    and no RoPE.  An int8 cache is dequantized to q's dtype.  Returns (y,
    new_k, new_v)."""
    if cross:
        # only q is read: the JAX package projects k and v too and its jit
        # drops them, unused
        q = _dense(p, "q", x_t, cfg, akey, 0).reshape(
            *x_t.shape[:-1], cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
    else:
        q, k_new, v_new = _project_qkv(p, x_t, x_t, cfg, akey)
        q = L.rope(q, pos[..., None], cfg.rope_theta)
        k_new = L.rope(k_new, pos[..., None], cfg.rope_theta)
        ring = _ring(cfg, cache_k)
        slot = pos % cfg.swa_window if ring else pos
        cache_k = _scatter_time(cache_k, k_new, slot)
        cache_v = _scatter_time(cache_v, v_new, slot)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(dequantize_kv(cache_k, q.dtype), n_rep)
    vv = _repeat_kv(dequantize_kv(cache_v, q.dtype), n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) \
        * (cfg.head_dim ** -0.5)
    if not cross:
        k_pos = torch.arange(cache_k.shape[1], device=x_t.device)
        if ring:
            # slot s holds absolute position pos - age, age = (pos - s) mod
            # window; valid once written
            w = cfg.swa_window
            age = (pos[:, None] % w - k_pos[None, :]) % w
            mask = ((pos[:, None] - age) >= 0)[:, None, None, :]
        else:
            mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", a, vv)
    out = out.reshape(*x_t.shape[:-1], cfg.n_heads * cfg.head_dim)
    okey = None if akey is None else prng.fold_in(akey, 3)
    y = L.dense_apply(p["o"], out, key=okey)
    return y, cache_k, cache_v
