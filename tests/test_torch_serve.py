"""End-to-end parity of the port's analog serving path with the JAX
package at smoke size (deepseek_7b.smoke_config(): 2 layers, d 64).

The JAX package's ``init_lm`` parameters go through
``repro_torch.analog.convert.from_jax_params``; ``prefill``, ``serve_step``
and ``greedy_generate`` then run in both packages with the same analog key
under three policies:

* ``noise_free`` (the reference read, no noise or bound),
* ``lm_managed:use_pallas=true:bm_mode=two_phase`` (the managed read; JAX
  runs its Pallas kernel in interpret mode, the port its plain version),
* ``lm_managed:use_pallas=true`` (iterative BM over the raw read).

Logits agree within 1e-4 absolute (|logit| ~ 3: f32 reassociation and
ulp-level noise differences through 2 layers), greedy tokens are equal.
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
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.analog.modules import AnalogState as TState
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.utils import prng

LOGIT_ATOL = 1e-4
POLICIES = ["noise_free", "lm_managed:use_pallas=true:bm_mode=two_phase",
            "lm_managed:use_pallas=true"]
AKEY, MAX_SEQ, N_STEPS = 7, 16, 3


def _numpy_tree(p):
    def leaf(n):
        if isinstance(n, JState):
            return {"w": np.asarray(n.w),
                    "seed": np.asarray(jax.random.key_data(n.seed)),
                    "meta": n.meta}
        return np.asarray(n)
    return jax.tree_util.tree_map(leaf, p,
                                  is_leaf=lambda n: isinstance(n, JState))


@functools.lru_cache(maxsize=None)
def _pair(spec):
    jcfg = dataclasses.replace(
        jregistry.get_config("deepseek_7b", smoke=True),
        param_dtype=jnp.float32, act_dtype=jnp.float32, remat=False,
        analog_policy=jpresets.parse_policy(spec))
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    tcfg = dataclasses.replace(
        tregistry.get_config("deepseek_7b", smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    return (pj, jcfg), (pt, tcfg), toks


@functools.lru_cache(maxsize=None)
def _jax_prefill(spec):
    (pj, jcfg), _, toks = _pair(spec)
    return jE.prefill(pj, jnp.asarray(toks, jnp.int32), jcfg,
                      max_seq=MAX_SEQ, akey=jax.random.key(AKEY))


def _port_prefill(spec):
    _, (pt, tcfg), toks = _pair(spec)
    with torch.no_grad():
        return tE.prefill(pt, torch.as_tensor(toks), tcfg, max_seq=MAX_SEQ,
                          akey=prng.key(AKEY))


@pytest.mark.parametrize("spec", POLICIES)
def test_prefill_logits_match_jax(spec):
    lj, cj = _jax_prefill(spec)
    lt, ct = _port_prefill(spec)
    assert lt.shape == lj.shape == (2, 1, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("spec", POLICIES)
def test_serve_step_logits_match_jax(spec):
    (pj, jcfg), (pt, tcfg), toks = _pair(spec)
    _, cj = _jax_prefill(spec)
    _, ct = _port_prefill(spec)
    step = jE.decode_step_key(jax.random.key(AKEY), 0)
    lj, _ = jE.serve_step(pj, jnp.asarray(toks[:, -1:], jnp.int32), cj,
                          jcfg, akey=step)
    with torch.no_grad():
        lt, nt = tE.serve_step(pt, torch.as_tensor(toks[:, -1:]), ct, tcfg,
                               akey=tE.decode_step_key(prng.key(AKEY), 0))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    assert nt["pos"].tolist() == [9, 9]


@pytest.mark.parametrize("spec", POLICIES)
def test_greedy_tokens_match_jax(spec):
    (pj, jcfg), (pt, tcfg), toks = _pair(spec)
    oj, _ = jE.greedy_generate(pj, jnp.asarray(toks, jnp.int32), jcfg,
                               n_steps=N_STEPS, max_seq=MAX_SEQ,
                               akey=jax.random.key(AKEY))
    with torch.no_grad():
        ot, _ = tE.greedy_generate(pt, torch.as_tensor(toks), tcfg,
                                   n_steps=N_STEPS, max_seq=MAX_SEQ,
                                   akey=prng.key(AKEY))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_converted_sites_and_seeds_match_jax():
    """211 = 7 * 30 + 1 analog sites at full depth: here 7 * 2 + 1, each a
    tile whose device seed equals the JAX package's."""
    (pj, _), (pt, tcfg), _ = _pair(POLICIES[1])
    tiles = [st for layer in pt["layers"]
             for blk in ("attn", "mlp") for st in layer[blk].values()]
    assert len(tiles) + 1 == 7 * tcfg.n_layers + 1
    assert isinstance(pt["unembed"], TState)
    port_own = tT.init_lm(0, tcfg, device="cpu")
    for path in (("attn", "q"), ("mlp", "wo")):
        for li in range(tcfg.n_layers):
            st = port_own["layers"][li][path[0]][path[1]]
            jst = pj["layers"][path[0]][path[1]]
            want = tuple(int(v) for v in np.asarray(
                jax.random.key_data(jst.seed))[li])
            assert st.seed == want
    assert port_own["unembed"].seed == tuple(
        int(v) for v in np.asarray(jax.random.key_data(pj["unembed"].seed)))


def test_init_cache_matches_prefill_layout():
    """A fresh cache has the stacked layout prefill emits."""
    _, ct = _port_prefill(POLICIES[0])
    _, (_, tcfg), toks = _pair(POLICIES[0])
    fresh = tE.init_cache(tcfg, toks.shape[0], MAX_SEQ, device="cpu")
    for k in ("k", "v"):
        assert fresh[k].shape == ct[k].shape
        assert fresh[k].dtype == ct[k].dtype
    assert fresh["pos"].shape == ct["pos"].shape
    assert int(fresh["k"].abs().sum()) == 0


def test_analog_serve_requires_key():
    """Analog params without ``akey`` fail at the first read."""
    _, (pt, tcfg), toks = _pair(POLICIES[1])
    with pytest.raises(ValueError, match="PRNG key"):
        tE.prefill(pt, torch.as_tensor(toks), tcfg, max_seq=MAX_SEQ)


@pytest.mark.parametrize("spec", [
    "lm_managed:use_pallas=true:bm_mode=two_phase", "noise_free", "managed",
    "*attn*=lm_managed,*mlp*=digital", "nm_bm:devices_per_weight=3"])
def test_parse_policy_matches_jax(spec):
    """The spec grammar resolves to the same RPUConfig fields."""
    jp, tp = jpresets.parse_policy(spec), tpresets.parse_policy(spec)
    assert len(jp.rules) == len(tp.rules)
    for jr, tr in zip(jp.rules, tp.rules):
        assert (jr.pattern, jr.name) == (tr.pattern, tr.name)
        if jr.cfg is None:
            assert tr.cfg is None
            continue
        for f in dataclasses.fields(tr.cfg):
            if f.name != "dtype":
                assert getattr(tr.cfg, f.name) == getattr(jr.cfg, f.name), \
                    f.name
