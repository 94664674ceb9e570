"""The encoder-decoder (seamless_m4t_medium's family, ``audio``): the port's
serving path against the JAX package's at the smoke size (2 encoder and 2
decoder layers, d 64, 4 heads of 16, vocab 256), float32.

The JAX package's ``init_lm`` parameters go through ``from_jax_params``
(``enc_layers`` unstacked like ``layers``, the decoder's ``cross`` blocks,
the frontend ``adapter``), so both packages start from the same weights
and tile seeds.  Prompts of 12 tokens and 15 stub frames (numpy, seeded)
then run through ``forward``, ``prefill`` and ``greedy_generate`` in both,
digital and under the noisy ``lm_managed`` (iterative BM on the reference
reads), with the same analog keys (the encoder's layers under
``fold_in(akey, 1000 + li)``, the adapter under 202, cross attention under
``fold_in(layer key, 102)``).

Tolerance: ``LOGIT_ATOL`` (1e-4, ``test_torch_serve.py``) absolute on
logits, on attention outputs and on every cache leaf (float32
reassociation through 4 layers; |logit| ~ 3); greedy tokens and positions
equal.  The flash kernel's plain version, bidirectional and cross (Sq 40
over Sk 60, and Sq 12 over Sk 15 at the smoke heads), is held against the
JAX package's Pallas ``flash_attention`` in interpret mode at
``test_torch_flash.py``'s rtol = atol = 2e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.analog.modules import AnalogState as JState
from repro.checkpoint import store as jstore
from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch.analog.convert import (from_jax_params, stack_layers,
                                        unstack_layers)
from repro_torch.analog.modules import AnalogState as TState
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.serve import scheduler as tsched
from repro_torch.utils import prng

from test_torch_serve import LOGIT_ATOL, _numpy_tree

ARCH = "seamless_m4t_medium"
NOISY = "lm_managed"
SPECS = [None, NOISY]
AKEY, B, S_TGT, S_SRC, MAX_SEQ, N_STEPS = 7, 2, 12, 15, 20, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(spec, flash=False):
    jcfg = dataclasses.replace(
        jregistry.get_config(ARCH, smoke=True), param_dtype=jnp.float32,
        act_dtype=jnp.float32, remat=False, use_flash_kernel=flash,
        analog_policy=None if spec is None else jpresets.parse_policy(spec))
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    tcfg = dataclasses.replace(
        tregistry.get_config(ARCH, smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32,
        use_flash_kernel=flash)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    return (pj, jcfg), (pt, tcfg)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S_TGT))
    frames = rng.normal(0, 0.5, (B, S_SRC, 64)).astype(np.float32)
    return toks, frames


def _akeys(spec):
    if spec is None:
        return None, None
    return jax.random.key(AKEY), prng.key(AKEY)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL, err_msg=what)


def test_config_is_the_jax_config():
    for smoke in (False, True):
        t = tregistry.get_config(ARCH, smoke=smoke)
        j = jregistry.get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(t):
            if f.name not in ("param_dtype", "act_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
    assert tregistry.canonical("seamless-m4t-medium") == ARCH
    assert t.family == "audio" and t.encoder_layers == 2


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_from_jax_params_takes_the_encoder_decoder_tree(spec):
    """Every leaf across in the JAX package's stacked layout, the tiles'
    seeds and weights equal; the encoder's layers unstack into a list and
    stack back."""
    (pj, _), (pt, _) = _pair(spec)
    assert len(pt["enc_layers"]) == 2 and len(pt["layers"]) == 2
    assert {"cross", "ln_cross"} <= set(pt["layers"][0])
    assert "cross" not in pt["enc_layers"][0] and "adapter" in pt
    got = tstore._flatten_with_paths(stack_layers(pt))
    want = jstore._flatten_with_paths(pj)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(tstore._to_numpy(a),
                                      jstore._to_numpy(b), err_msg=k)
    if spec is not None:
        assert isinstance(pt["enc_layers"][1]["attn"]["q"], TState)
        assert isinstance(pt["layers"][0]["cross"]["k"], TState)
        assert isinstance(pj["layers"]["cross"]["k"], JState)
    back = unstack_layers(stack_layers(pt), 2, enc_layers=2)
    again = tstore._flatten_with_paths(stack_layers(back))
    assert [k for k, _ in again] == [k for k, _ in got]


def test_jax_weights_are_jax_init():
    """``init_lm(jax_weights=True)`` draws the JAX package's weights for
    the encoder-decoder (encoder, cross attention and adapter included),
    within 3 ulp."""
    cj = jregistry.get_config(ARCH, smoke=True)
    ct = dataclasses.replace(tregistry.get_config(ARCH, smoke=True),
                             param_dtype=torch.float32)
    got = tstore._flatten_with_paths(stack_layers(tT.init_lm(
        3, ct, device="cpu", jax_weights=True)))
    want = jstore._flatten_with_paths(jT.init_lm(
        jax.random.key(3), dataclasses.replace(
            cj, param_dtype=jnp.float32))[0])[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        a, b = tstore._to_numpy(a), jstore._to_numpy(b)
        ulp = np.abs(a.view(np.int32).astype(np.int64)
                     - b.view(np.int32).astype(np.int64))
        assert a.shape == b.shape and ulp.max() <= 3, k


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_forward_matches_jax(spec):
    (pj, jcfg), (pt, tcfg) = _pair(spec)
    jk, tk = _akeys(spec)
    toks, frames = _inputs()
    lj, _ = jT.forward(pj, jnp.asarray(toks), jcfg,
                       enc_embeds=jnp.asarray(frames), akey=jk)
    with torch.no_grad():
        lt, aux = tT.forward(pt, torch.as_tensor(toks), tcfg,
                             enc_embeds=torch.as_tensor(frames), akey=tk)
    assert lt.shape == (B, S_TGT, 256) and float(aux) == 0.0
    _close(lt.numpy(), lj)
    with pytest.raises(ValueError, match="enc_embeds"):
        tT.forward(pt, torch.as_tensor(toks), tcfg)


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_greedy_generate_matches_jax(spec):
    """Prefill and ``N_STEPS - 1`` decode steps: tokens equal, every cache
    leaf (k, v, the static cross_k / cross_v, pos) within tolerance, and
    the prefill's logits."""
    (pj, jcfg), (pt, tcfg) = _pair(spec)
    jk, tk = _akeys(spec)
    toks, frames = _inputs(2)
    lj, _ = jE.prefill(pj, jnp.asarray(toks, jnp.int32), jcfg,
                       max_seq=MAX_SEQ, enc_embeds=jnp.asarray(frames),
                       akey=jk)
    gj, cj = jE.greedy_generate(pj, jnp.asarray(toks, jnp.int32), jcfg,
                                n_steps=N_STEPS, max_seq=MAX_SEQ,
                                enc_embeds=jnp.asarray(frames), akey=jk)
    with torch.no_grad():
        lt, _ = tE.prefill(pt, torch.as_tensor(toks), tcfg, max_seq=MAX_SEQ,
                           enc_embeds=torch.as_tensor(frames), akey=tk)
        gt, ct = tE.greedy_generate(pt, torch.as_tensor(toks), tcfg,
                                    n_steps=N_STEPS, max_seq=MAX_SEQ,
                                    enc_embeds=torch.as_tensor(frames),
                                    akey=tk)
    _close(lt.numpy(), lj, "prefill logits")
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert set(ct) == set(cj) == {"k", "v", "cross_k", "cross_v", "pos"}
    for k in cj:
        assert tuple(ct[k].shape) == tuple(cj[k].shape), k
        if k == "pos":
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        else:
            _close(ct[k].numpy(), cj[k], k)
    assert ct["cross_k"].shape == (2, B, S_SRC, 4, 16)
    fresh = tE.init_cache(tcfg, B, MAX_SEQ, src_len=S_SRC, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in ct.items()}


@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "flash"])
def test_cross_attention_matches_jax(flash):
    """A decoder layer's cross attention, 12 queries over 15 keys (and the
    encoder's bidirectional self-attention), against JAX's
    ``attention.forward(x_kv=...)``; with ``flash`` the port runs the
    kernel's plain version and JAX its Pallas kernel in interpret mode."""
    (pj, jcfg), (pt, tcfg) = _pair(None, flash)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S_TGT, 64)).astype(np.float32)
    mem = rng.standard_normal((B, S_SRC, 64)).astype(np.float32)
    take = lambda t, i: jax.tree_util.tree_map(lambda a: a[i], t)  # noqa
    jp = take(pj["layers"]["cross"], 0)
    pos = np.arange(S_TGT)[None]
    yj, (kj, vj) = jattn.forward(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), causal=False,
                                 x_kv=jnp.asarray(mem), return_kv=True)
    yt, (kt, vt) = tattn.forward(pt["layers"][0]["cross"],
                                 torch.as_tensor(x), tcfg,
                                 positions=torch.as_tensor(pos),
                                 causal=False, x_kv=torch.as_tensor(mem),
                                 return_kv=True)
    assert yt.shape == (B, S_TGT, 64) and kt.shape == (B, S_SRC, 4, 16)
    for got, want, what in ((yt, yj, "y"), (kt, kj, "k"), (vt, vj, "v")):
        _close(got.detach().numpy(), want, what)
    ej = take(pj["enc_layers"]["attn"], 1)
    pos = np.arange(S_SRC)[None]
    want = jattn.forward(ej, jnp.asarray(mem), jcfg,
                         positions=jnp.asarray(pos), causal=False)
    got = tattn.forward(pt["enc_layers"][1]["attn"], torch.as_tensor(mem),
                        tcfg, positions=torch.as_tensor(pos), causal=False)
    _close(got.detach().numpy(), want, "encoder self-attention")


@pytest.mark.parametrize("sq,sk,causal", [(40, 40, False), (40, 60, False),
                                          (S_TGT, S_SRC, False)],
                         ids=["bidirectional", "cross", "cross_smoke"])
def test_flash_plain_matches_jax_kernel(sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((B, sq, 4, 16), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, sk, 4, 16), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, sk, 4, 16), dtype=np.float32) * 0.5
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, interpret=True)
    before = tfa.launches
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert tfa.launches == before          # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_serve_cli_on_the_cpu(capsys, monkeypatch):
    """The driver serves the smoke model with the JAX driver's stub frames
    (drawn after the prompts from one generator, in the act dtype)."""
    cfg = tregistry.get_config(ARCH, smoke=True)
    frames = tserve.make_frames(cfg, 2, 6, 0, "cpu")
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab, (2, 6))
    want = jnp.asarray(rng.normal(0, 0.5, (2, 6, 64)), jnp.bfloat16)
    assert frames.dtype == torch.bfloat16
    np.testing.assert_array_equal(frames.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert tserve.make_frames(tregistry.get_config("deepseek_7b", True), 2,
                              6, 0, "cpu") is None
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
        "2", "--prompt-len", "6", "--gen", "3", "--analog-policy", NOISY])
    tserve.main()
    out = capsys.readouterr().out
    assert "enc_layers/attn/q" in out and "layers/cross/q" in out
    assert f"[serve {ARCH}] generated (2, 3)" in out


def test_continuous_batching_refuses_the_encoder_decoder():
    _, (pt, tcfg) = _pair(None)
    with pytest.raises(NotImplementedError, match="encoder memories"):
        tsched.ContinuousBatchingScheduler(pt, tcfg, slots=2, max_seq=16)
