"""flash_attention: online-softmax attention forward (the LM prefill).

Replaces the TPU kernel ``flash_attention`` (``src/repro/kernels/
flash_attention.py:83``, ``pallas_call`` at :111) with the CUDA kernel
``csrc/flash_attention.cu``: one block per (batch, head, 64 query rows in
bfloat16, 128 in float32) walks the key blocks with the running max, sum
and float32 accumulator in registers; K and V arrive in 64-key chunks
through a ``cp.async`` ring in shared memory, and the scores never leave
registers.  bfloat16 runs both products on the tensor cores (``mma.sync``
m16n8k16, f32 accumulation, 16 query rows per warp); float32 runs IEEE
FMAs on the CUDA cores (no TF32) in 8x4 score and 8x(D/16) output register
tiles per thread.  Causal, sliding-window and key-padding masks by
absolute position with the finite ``NEG_INF = -1e30``; ``block_k`` is the
softmax block (the TPU's, 128 by default): P rounds to V's dtype at that
block's running max before the P V product, which accumulates in float32.
K and V may carry fewer heads than q (grouped-query attention): query head
``h`` reads kv head ``h // (H / Hkv)``, as ``repeat_kv`` lays them out.
Bound: its multiply-adds, at float32 on the CUDA cores, at bfloat16 on the
tensor cores, where the bytes come close.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` only for CPU tensors.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
BLOCK_KS = (64, 128)

#: Kernel launches since the last reset (``ops.reset_launch_counts``).
launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, S, H, D) with k and v "
                         "alike")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         "batch, head dim or head groups differ")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise TypeError(f"q, k, v are all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's recurrence over key blocks
    of ``block_k`` (zero-padded), all query rows at once."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    sk_p = -(-sk // block_k) * block_k
    pad = (0, 0, 0, 0, 0, sk_p - sk)
    kh = torch.nn.functional.pad(k, pad).repeat_interleave(n_rep, dim=2)
    vh = torch.nn.functional.pad(v, pad).repeat_interleave(n_rep, dim=2)
    qh = q.permute(0, 2, 1, 3).float()               # (B, H, Sq, D)
    kh = kh.permute(0, 2, 1, 3).float()
    vh = vh.permute(0, 2, 1, 3)
    scale = torch.tensor(np.float32(d ** -0.5), device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_ = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk_p, block_k):
        s = torch.matmul(qh, kh[:, :, k0:k0 + block_k].transpose(-1, -2)) \
            * scale
        k_pos = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(v.dtype).float(), vh[:, :, k0:k0 + block_k].float())
        m = m_new
    out = acc / torch.clamp_min(l_[..., None], 1e-30)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Sk, Hkv, D)`` (H a
    multiple of Hkv), float32 or bfloat16; returns ``(B, Sq, H, D)`` in q's
    dtype.  ``window > 0`` keeps keys with ``q - k < window``."""
    global launches
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_k=block_k)
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must start 16-byte aligned (the "
                             "kernel copies 16-byte chunks)")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS or block_k not in BLOCK_KS:
        raise ValueError(f"head dim {d} / block_k {block_k}: the kernel "
                         f"takes {HEAD_DIMS} / {BLOCK_KS}")
    # causal blocks above the diagonal are skipped unless a query row has
    # no valid key at all (causal window past the keys' end), whose result
    # depends on every padded slot
    skip_upper = causal and not (window > 0 and sq > sk + window - 1)
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, sk, h, hkv, d, int(causal), int(window), block_k,
                int(skip_upper), float(np.float32(d ** -0.5)),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
