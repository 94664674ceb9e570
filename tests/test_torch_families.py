"""The ssm and hybrid families and stablelm_3b: the port's serving path
against the JAX package at smoke size, in float32.

stablelm_3b (dense), mamba2_130m (ssm: SSD blocks, tied embeddings) and
hymba_1_5b (hybrid: sliding-window attention beside an SSD branch,
averaged).  The JAX package's ``init_lm`` parameters go through
``repro_torch.analog.convert.from_jax_params``, so both packages start
from the same weights and tile seeds; ``forward``, ``prefill``,
``serve_step`` and ``greedy_generate`` then run in both with the same
tokens (numpy, seeded) and analog keys, digital, under ``noise_free`` and
under the noisy ``lm_managed`` (iterative BM on the reference reads).

Tolerance: ``LOGIT_ATOL`` (``test_torch_serve.py``) absolute on logits and
on every cache leaf (|logit| ~ 3.5, |k|, |v| ~ 4, the SSD state ~ 0.1:
float32 reassociation through 2 layers); greedy tokens and positions
equal.  Prompts of 40 tokens run past hymba's smoke window (32) and over
two SSD chunks (32).  The ring cache is held leaf for leaf through 20
decode steps past an 8-token window, from a prompt shorter than the
window and one longer, and the linear cache that ``max_seq`` below the
window gives.
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
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch.analog.convert import from_jax_params, stack_layers
from repro_torch.analog.modules import AnalogState as TState
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.utils import prng

from test_torch_serve import LOGIT_ATOL, _numpy_tree

ARCHS = ["stablelm_3b", "mamba2_130m", "hymba_1_5b"]
NOISY = "lm_managed"
SPECS = [None, "noise_free", NOISY]
AKEY, S_LONG, MAX_SEQ = 7, 40, 48


@functools.lru_cache(maxsize=None)
def _pair(arch, spec, window=None):
    over = {} if window is None else {"swa_window": window}
    jcfg = dataclasses.replace(
        jregistry.get_config(arch, smoke=True), param_dtype=jnp.float32,
        act_dtype=jnp.float32, remat=False,
        analog_policy=None if spec is None else jpresets.parse_policy(spec),
        **over)
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    tcfg = dataclasses.replace(
        tregistry.get_config(arch, smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32, **over)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    return (pj, jcfg), (pt, tcfg)


def _toks(s=S_LONG, b=2, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _akeys(spec):
    if spec is None:
        return None, None
    return jax.random.key(AKEY), prng.key(AKEY)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL, err_msg=what)


def _close_cache(ct, cj):
    assert set(ct) == set(cj)
    for k in cj:
        assert tuple(ct[k].shape) == tuple(cj[k].shape), k
        if k == "pos":
            assert ct[k].dtype == torch.int32
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        else:
            _close(ct[k].numpy(), cj[k], k)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, spec):
    (pj, jcfg), _ = _pair(arch, spec)
    return jE.prefill(pj, jnp.asarray(_toks(), jnp.int32), jcfg,
                      max_seq=MAX_SEQ, akey=_akeys(spec)[0])


@functools.lru_cache(maxsize=None)
def _port_prefill(arch, spec):
    _, (pt, tcfg) = _pair(arch, spec)
    with torch.no_grad():
        return tE.prefill(pt, torch.as_tensor(_toks()), tcfg,
                          max_seq=MAX_SEQ, akey=_akeys(spec)[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    for smoke in (False, True):
        assert (tregistry.get_config(arch, smoke=smoke).param_count()
                == jregistry.get_config(arch, smoke=smoke).param_count())


def test_configs_are_jax_configs():
    """The published and smoke numbers, field for field."""
    for arch in ARCHS:
        for smoke in (False, True):
            t = tregistry.get_config(arch, smoke=smoke)
            j = jregistry.get_config(arch, smoke=smoke)
            for f in dataclasses.fields(t):
                if f.name in ("param_dtype", "act_dtype"):
                    continue
                tv, jv = getattr(t, f.name), getattr(j, f.name)
                if f.name == "ssm" and tv is not None:
                    tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
                assert tv == jv, (arch, smoke, f.name)
    assert tregistry.canonical("hymba-1.5b") == "hymba_1_5b"
    assert tregistry.canonical("mamba2-130m") == "mamba2_130m"
    assert tregistry.canonical("stablelm-3b") == "stablelm_3b"


def test_unported_families_raise():
    from repro_torch.configs.base import ModelConfig
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        ModelConfig(name="x", family="moe", n_layers=1, d_model=8,
                    n_heads=1, n_kv_heads=1, d_ff=8, vocab=8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", [None, NOISY])
def test_forward_matches_jax(arch, spec):
    (pj, jcfg), (pt, tcfg) = _pair(arch, spec)
    jk, tk = _akeys(spec)
    lj, _ = jT.forward(pj, jnp.asarray(_toks()), jcfg, akey=jk)
    with torch.no_grad():
        lt, aux = tT.forward(pt, torch.as_tensor(_toks()), tcfg, akey=tk)
    assert lt.shape == (2, S_LONG, 256) and float(aux) == 0.0
    _close(lt.numpy(), lj)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", SPECS)
def test_prefill_matches_jax(arch, spec):
    """Logits and every cache leaf: k/v (hymba: a ring of 32 slots for
    the 40-token prompt), ssm_conv, ssm_state, pos."""
    lj, cj = _jax_prefill(arch, spec)
    lt, ct = _port_prefill(arch, spec)
    assert lt.shape == (2, 1, 256)
    _close(lt.numpy(), lj)
    _close_cache(ct, cj)
    want = {"stablelm_3b": {"k", "v", "pos"},
            "mamba2_130m": {"ssm_conv", "ssm_state", "pos"},
            "hymba_1_5b": {"k", "v", "ssm_conv", "ssm_state", "pos"}}[arch]
    assert set(ct) == want
    if arch == "hymba_1_5b":
        assert ct["k"].shape[2] == 32           # min(window, max_seq)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", SPECS)
def test_serve_step_matches_jax(arch, spec):
    (pj, jcfg), (pt, tcfg) = _pair(arch, spec)
    _, cj = _jax_prefill(arch, spec)
    _, ct = _port_prefill(arch, spec)
    jk, tk = _akeys(spec)
    last = _toks()[:, -1:]
    lj, nj = jE.serve_step(pj, jnp.asarray(last, jnp.int32), cj, jcfg,
                           akey=None if jk is None
                           else jE.decode_step_key(jk, 0))
    with torch.no_grad():
        lt, nt = tE.serve_step(pt, torch.as_tensor(last), ct, tcfg,
                               akey=tE.decode_step_key(tk, 0))
    _close(lt.numpy(), lj)
    _close_cache(nt, nj)
    assert nt["pos"].tolist() == [S_LONG + 1] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(S-1) + one serve_step == the full forward's last-position
    logits (the port alone, digital; hymba's prompt past its window)."""
    _, (pt, tcfg) = _pair(arch, None)
    toks = torch.as_tensor(_toks(S_LONG + 1))
    with torch.no_grad():
        full, _ = tT.forward(pt, toks, tcfg)
        _, cache = tE.prefill(pt, toks[:, :-1], tcfg, max_seq=MAX_SEQ)
        step, _ = tE.serve_step(pt, toks[:, -1:], cache, tcfg)
    _close(step[:, 0].numpy(), full[:, -1].numpy())


@pytest.mark.parametrize("window,prompt,n_steps", [
    (8, 6, 21),        # a ring of 8, the prompt padded into it
    (8, 12, 21),       # a ring of 8, the prompt's last 8 keys scattered
    (32, 6, 12),       # max_seq 18 < window 32: a linear cache
])
def test_ring_decode_leaf_for_leaf(window, prompt, n_steps):
    """Greedy decode 20 steps past an 8-token window (and the linear cache
    of max_seq below the window): tokens equal, every cache leaf within
    ``LOGIT_ATOL`` of JAX's."""
    (pj, jcfg), (pt, tcfg) = _pair("hymba_1_5b", None, window)
    toks = _toks(prompt)
    max_seq = prompt + n_steps
    oj, cj = jE.greedy_generate(pj, jnp.asarray(toks, jnp.int32), jcfg,
                                n_steps=n_steps, max_seq=max_seq)
    with torch.no_grad():
        ot, ct = tE.greedy_generate(pt, torch.as_tensor(toks), tcfg,
                                    n_steps=n_steps, max_seq=max_seq)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    _close_cache(ct, cj)
    assert ct["k"].shape[2] == min(window, max_seq)


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
def test_hybrid_prefill_key_quirk(arch):
    """The JAX package reads a hybrid block's SSD branch under the layer
    key in ``block_prefill`` but under ``fold_in(layer key, 101)`` in
    ``_block_apply`` and ``block_decode``.  Under noise, hymba's prefill
    logits therefore differ from its forward's last position, in both
    packages alike; mamba2 (one key for its only branch) agrees."""
    (pj, jcfg), (pt, tcfg) = _pair(arch, NOISY)
    jk, tk = _akeys(NOISY)
    fj, _ = jT.forward(pj, jnp.asarray(_toks()), jcfg, akey=jk)
    with torch.no_grad():
        ft, _ = tT.forward(pt, torch.as_tensor(_toks()), tcfg, akey=tk)
    pj_logits, _ = _jax_prefill(arch, NOISY)
    pt_logits, _ = _port_prefill(arch, NOISY)
    gap_j = float(np.abs(np.asarray(fj)[:, -1] - np.asarray(pj_logits)[:, 0])
                  .max())
    gap_t = float((ft[:, -1] - pt_logits[:, 0]).abs().max())
    if arch == "hymba_1_5b":
        assert gap_j > 100 * LOGIT_ATOL and gap_t > 100 * LOGIT_ATOL
        assert abs(gap_t - gap_j) <= 2 * LOGIT_ATOL
    else:
        assert gap_j <= LOGIT_ATOL and gap_t <= LOGIT_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_prefill_layout(arch):
    _, ct = _port_prefill(arch, None)
    _, (_, tcfg) = _pair(arch, None)
    fresh = tE.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert set(fresh) == set(ct)
    for k in ct:
        assert fresh[k].shape == ct[k].shape, k
        assert fresh[k].dtype == ct[k].dtype, k
        assert int(fresh[k].abs().sum()) == 0
    assert tE.cache_len_for(tcfg, MAX_SEQ) == {
        "stablelm_3b": MAX_SEQ, "mamba2_130m": 0, "hymba_1_5b": 32}[arch]


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
def test_converted_sites_and_seeds_match_jax(arch):
    """The SSD projections become tiles whose device seeds equal the JAX
    package's; mamba2's tree has no unembed (tied)."""
    (pj, _), (_, tcfg) = _pair(arch, NOISY)
    own = tT.init_lm(0, tcfg, device="cpu")
    assert ("unembed" in own) == (arch != "mamba2_130m")
    for site in ("in_proj", "out_proj"):
        jst = pj["layers"]["ssm"][site]
        assert isinstance(jst, JState)
        for li in range(tcfg.n_layers):
            st = own["layers"][li]["ssm"][site]
            assert isinstance(st, TState)
            assert st.seed == tuple(int(v) for v in np.asarray(
                jax.random.key_data(jst.seed))[li])


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_weights_are_jax_init(arch):
    """``init_lm(jax_weights=True)`` draws the JAX package's weights for
    every family: leaf for leaf in the stacked layout, within 3 ulp."""
    cfg_j = jregistry.get_config(arch, smoke=True)
    cfg_t = tregistry.get_config(arch, smoke=True)
    got = [(k, tstore._to_numpy(v)) for k, v in tstore._flatten_with_paths(
        stack_layers(tT.init_lm(3, cfg_t, device="cpu", jax_weights=True)))]
    want = [(k, jstore._to_numpy(v)) for k, v in jstore._flatten_with_paths(
        jT.init_lm(jax.random.key(3), cfg_j)[0])[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        it = np.int16 if a.itemsize == 2 else np.int32
        ulp = np.abs(a.view(it).astype(np.int64) - b.view(it).astype(
            np.int64))
        assert ulp.max() <= (0 if a.itemsize == 2 else 3), k


def test_training_refuses_ssm_and_hybrid():
    """The record of a lifted refusal: the driver once refused to train the
    ssm and hybrid families, and later the encoder-decoder; the test keeps
    its name since they train now (``test_torch_ssm_train.py``,
    ``test_torch_hybrid_train.py``, ``test_torch_encdec_train.py``).
    ``lm_config`` returns their configs; the MoE and VLM archs are still
    refused with the ROADMAP Queue 1 item 6 message; stablelm_3b, dense,
    trains."""
    for arch, family in (("mamba2_130m", "ssm"), ("hymba_1_5b", "hybrid"),
                         ("seamless_m4t_medium", "audio")):
        assert ttrain.lm_config(arch, smoke=True).family == family
        assert ttrain.lm_config(arch, smoke=True,
                                analog_policy="lm_managed").uses_analog
    for arch in ("mixtral_8x7b", "pixtral_12b"):
        with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
            ttrain.lm_config(arch, smoke=True)
        with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
            ttrain.train(arch, steps=1, batch=2, seq=8, smoke=True,
                         device="cpu")
    assert ttrain.lm_config("stablelm_3b", smoke=True).family == "dense"


@pytest.mark.parametrize("window,q_offset", [(0, 0), (6, 0), (6, 16),
                                             (0, 16)])
def test_chunked_attention_window_matches_jax(window, q_offset):
    """The chunked fallback (``attention._flash``) with a sliding window
    and a query offset, chunks of 8 over 20 queries and 36 keys."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, s, 2, 8)).astype(np.float32)
               for s in (20, 36, 36))
    kw = dict(causal=True, window=window, chunk_q=8, chunk_k=8,
              q_offset=q_offset)
    want = jattn._flash(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tattn._flash(*(torch.as_tensor(a) for a in (q, k, v)), **kw)
    _close(got.numpy(), want)
