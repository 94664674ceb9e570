"""Grouped-query causal self-attention: chunked online-softmax prefill and
single-token decode over a KV cache.

The projections go through ``layers.dense_apply``, so an analog policy
turns them into managed array reads; their read keys are
``fold_in(akey, 0/1/2)`` for q/k/v and ``fold_in(akey, 3)`` for o, as in the
JAX package.  Prefill attention is the plain-PyTorch chunked online-softmax
loop (the JAX package's ``_flash`` fallback); the Pallas flash-attention
kernel is not part of this package yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils import prng

Tensor = torch.Tensor

NEG_INF = -1e30


def init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """QKVO projection params (digital; analog conversion is policy-driven)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mk = lambda d_in, d_out: L.dense_init(gen, d_in, d_out, cfg.param_dtype,
                                          device)
    return {"q": mk(d, h * hd), "k": mk(d, hkv * hd), "v": mk(d, hkv * hd),
            "o": mk(h * hd, d)}


def _project_qkv(p, x_q: Tensor, x_kv: Tensor, cfg: ModelConfig, akey=None):
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(name, xx, i):
        k = None if akey is None else prng.fold_in(akey, i)
        return L.dense_apply(p[name], xx, key=k)

    q = dense("q", x_q, 0).reshape(*x_q.shape[:-1], h, hd)
    k = dense("k", x_kv, 1).reshape(*x_kv.shape[:-1], hkv, hd)
    v = dense("v", x_kv, 2).reshape(*x_kv.shape[:-1], hkv, hd)
    return q, k, v


def _repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, chunk_q: int,
           chunk_k: int) -> Tensor:
    """Online-softmax chunked attention.  q: (B, Sq, H, D); k, v: (B, Sk,
    H, D) (kv already head-repeated)."""
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
        q_pos = torch.arange(nq, device=q.device) + q0
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
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, None], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_ = l_ * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", pr.to(v_blk.dtype), v_blk).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l_[..., None], 1e-30))
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def forward(p, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
            akey=None, chunk_q: int = 512, chunk_k: int = 512,
            return_kv: bool = False):
    """Causal self-attention over a full sequence (prefill)."""
    q, k, v = _project_qkv(p, x, x, cfg, akey)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _flash(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=True,
                 chunk_q=chunk_q, chunk_k=chunk_k)
    out = out.reshape(*out.shape[:-2], cfg.n_heads * cfg.head_dim)
    okey = None if akey is None else prng.fold_in(akey, 3)
    y = L.dense_apply(p["o"], out, key=okey)
    if return_kv:
        return y, (k, v)
    return y


def _scatter_time(cache: Tensor, new: Tensor, slot: Tensor) -> Tensor:
    """cache (B,S,H,D) <- new (B,1,H,D) at per-batch time index ``slot``
    (a new tensor; the input cache is left as it was)."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), slot] = \
        new[:, 0].to(cache.dtype)
    return out


def decode(p, x_t: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor,
           cfg: ModelConfig, *, akey=None):
    """Single-token decode.  x_t: (B, 1, d); cache_k/v: (B, S_cache, Hkv,
    hd), written at ``pos``.  Returns (y, new_k, new_v)."""
    q, k_new, v_new = _project_qkv(p, x_t, x_t, cfg, akey)
    q = L.rope(q, pos[..., None], cfg.rope_theta)
    k_new = L.rope(k_new, pos[..., None], cfg.rope_theta)
    cache_k = _scatter_time(cache_k, k_new, pos)
    cache_v = _scatter_time(cache_v, v_new, pos)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(cache_k, n_rep)
    vv = _repeat_kv(cache_v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) \
        * (cfg.head_dim ** -0.5)
    k_pos = torch.arange(cache_k.shape[1], device=x_t.device)
    mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", a, vv)
    out = out.reshape(*x_t.shape[:-1], cfg.n_heads * cfg.head_dim)
    okey = None if akey is None else prng.fold_in(akey, 3)
    y = L.dense_apply(p["o"], out, key=okey)
    return y, cache_k, cache_v
