"""Parity of the port's flash attention with the JAX package.

* The plain version of the flash-attention kernel (what the wrapper runs on
  the CPU) against JAX's Pallas ``flash_attention`` in interpret mode over
  the five cases of ``tests/test_flash_attention.py`` (causal, non-aligned,
  bidirectional, sliding window, cross Sq != Sk), float32 inputs from a
  numpy seed, at that test's rtol/atol 2e-5 (f32 reassociation of the score
  and P V sums); a grouped-query case (JAX repeats K/V, the port indexes
  them); and bfloat16 cases within BF16 (below).
* The chunked fallback ``attention._flash`` against JAX's ``_flash`` at
  bfloat16 over two chunks of 512: P rounds to bf16 and the P V product
  accumulates in float32 in both, so at most 0.1% of outputs may differ,
  each within BF16.
* The CUDA kernel against its plain version (needs the card).

BF16: P rounds to bf16 at the same block's running max on both sides, so
only a score an f32 ulp apart can flip the rounding of one P entry (2^-8
of it), and the output rounds to bf16 (2^-9 of |out| on each side).  Each
output may therefore differ by 2^-7 of the sum of its terms' magnitudes,
``sum_k a_k |v_k|`` (a the softmax weights); an output that cancels to near
zero keeps that absolute scale, not its own ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

CASES = [
    # (b, sq, sk, h, d, causal, window, bq, bk) of tests/test_flash_attention
    (2, 128, 128, 2, 64, True, 0, 64, 64),
    (1, 200, 200, 3, 32, True, 0, 64, 64),      # non-block-aligned
    (2, 128, 128, 2, 64, False, 0, 64, 64),     # bidirectional (encoder)
    (1, 256, 256, 2, 64, True, 96, 64, 64),     # sliding window
    (1, 64, 256, 2, 64, False, 0, 64, 64),      # cross-attn (Sq != Sk)
]
BF16_CASES = [
    # (b, sq, sk, h, d, causal, window, bk)
    (1, 128, 128, 2, 64, True, 0, 128),         # tests/test_flash_bf16
    (1, 300, 300, 2, 64, True, 0, 128),         # three softmax blocks
]


def _qkv(b, sq, sk, h, d, seed, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32) * 0.5
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32) * 0.5
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32) * 0.5
    return q, k, v


def _bf16_tol(q, k, v, **kw):
    """2^-7 of each output's ``sum_k a_k |v_k|`` (float32 attention of
    |v|)."""
    mag = tfa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                    **kw)
    return 2.0 ** -7 * mag.numpy()


@pytest.mark.parametrize("b,sq,sk,h,d,causal,window,bq,bk", CASES)
def test_plain_matches_jax_kernel(b, sq, sk, h, d, causal, window, bq, bk):
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + sk + h)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=bq, block_k=bk,
                  interpret=True)
    before = tfa.launches
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, block_k=bk)
    assert tfa.launches == before          # the CPU runs the plain version
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_grouped_kv_matches_repeated_kv():
    """K/V with 2 heads for 6 query heads: head h reads kv head h // 3, as
    JAX's repeat_kv lays them out before its kernel."""
    q, k, v = _qkv(2, 150, 150, 6, 32, seed=5, hkv=2)
    rep = lambda a: jnp.repeat(jnp.asarray(a), 3, axis=2)
    want = jflash(jnp.asarray(q), rep(k), rep(v), causal=True,
                  interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,window,bk", BF16_CASES)
def test_plain_bf16_within_one_ulp_of_jax(b, sq, sk, h, d, causal, window,
                                          bk):
    q, k, v = _qkv(b, sq, sk, h, d, seed=11)
    want = jflash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                  causal=causal, window=window, block_k=bk, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = dict(causal=causal, window=window, block_k=bk)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (diff <= _bf16_tol(tq, tk, tv, **kw)).all(), float(diff.max())


def test_fallback_bf16_accumulates_pv_in_f32_like_jax():
    """Two 512-chunks of a 640-token prompt at bf16: P rounded to bf16,
    P V accumulated in float32, as JAX's ``_flash`` does."""
    q, k, v = _qkv(1, 640, 640, 4, 64, seed=3)
    want = jattn._flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                          for a in (q, k, v)), causal=True, window=0,
                        chunk_q=512, chunk_k=512)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tattn._flash(tq, tk, tv, causal=True, chunk_q=512, chunk_k=512)
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert float((diff > 0).mean()) <= 1e-3
    assert (diff <= _bf16_tol(tq, tk, tv, causal=True)).all(), \
        float(diff.max())


def test_bad_operands_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 16, seed=1,
                                                 hkv=3))
    with pytest.raises(ValueError, match="head groups"):
        tfa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 16, seed=1))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        tfa.flash_attention(q.double(), k.double(), v.double())


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,window,bq,bk", CASES + [
    (2, 1000, 1000, 8, 128, True, 0, 128, 128),   # the qwen3 prefill's
    (1, 300, 100, 2, 64, True, 40, 128, 128),     # rows with no valid key
])
def test_cuda_kernel_matches_plain(b, sq, sk, h, d, causal, window, bq, bk,
                                   dtype, cuda):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _qkv(b, sq, sk, h, d,
                                                        seed=7))
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_k=bk)
    got = tfa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                              causal=causal, window=window, block_k=bk)
    torch.cuda.synchronize()
    got, want = got.cpu().float().numpy(), want.float().numpy()
    if dt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert (np.abs(got - want) <= _bf16_tol(
            q, k, v, causal=causal, window=window, block_k=bk)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 40)])
def test_cuda_kernel_every_head_dim_and_block(d, bk, causal, window, dtype,
                                              cuda):
    """Every head dim and softmax block, grouped kv heads (4 over 2),
    ragged Sq 200 / Sk 190 (no multiple of the 64-key chunk); the causal
    window past the keys' end leaves rows 229.. with no valid key."""
    dt = getattr(torch, dtype)
    q, _, _ = _qkv(1, 230, 190, 4, d, seed=d + bk)
    _, k, v = _qkv(1, 230, 190, 2, d, seed=d + bk + 1)
    q, k, v = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    kw = dict(causal=causal, window=window, block_k=bk)
    want = tfa.flash_attention_plain(q, k, v, **kw)
    got = tfa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    got, want = got.cpu().float().numpy(), want.float().numpy()
    if dt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert (np.abs(got - want) <= _bf16_tol(q, k, v, **kw)).all()
