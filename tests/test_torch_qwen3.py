"""End-to-end parity of the port's qwen3_14b serving with the JAX package at
smoke size (qwen3_14b.smoke_config(): 2 layers, d 64, 4 heads over 2 kv
heads, d_head 16, qk-norm, rope theta 1e6).

The JAX package's ``init_lm`` parameters (q_norm / k_norm included) go
through ``repro_torch.analog.convert.from_jax_params``; ``prefill``,
``serve_step`` and ``greedy_generate`` then run in both packages in float32,
digital and under ``lm_managed:use_pallas=true:bm_mode=two_phase``, with
``use_flash_kernel`` off (the chunked fallback) and on (JAX: its Pallas
kernel in interpret mode; the port: the plain version of its kernel).
Logits agree within ``test_torch_serve.LOGIT_ATOL``, greedy tokens are
equal.  The converted sites' tile seeds match JAX's at smoke size and, on a
skeleton tree of tiny weights, at the full depth of 40 layers (281 sites).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import convert as jconvert
from repro.analog import presets as jpresets
from repro.configs import registry as jregistry
from repro.core.device import RPUConfig as JRPUConfig
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch.analog import convert as tconvert
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.analog.modules import AnalogState as TState
from repro_torch.configs import registry as tregistry
from repro_torch.core.device import RPUConfig as TRPUConfig
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.utils import prng

from test_torch_serve import LOGIT_ATOL, _numpy_tree

TWO_PHASE = "lm_managed:use_pallas=true:bm_mode=two_phase"
SPECS = [None, TWO_PHASE]
FLASH = [False, True]
AKEY, MAX_SEQ, N_STEPS = 7, 16, 3
SITES = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
         ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


@functools.lru_cache(maxsize=None)
def _pair(spec, flash):
    jcfg = dataclasses.replace(
        jregistry.get_config("qwen3_14b", smoke=True),
        param_dtype=jnp.float32, act_dtype=jnp.float32, remat=False,
        use_flash_kernel=flash,
        analog_policy=None if spec is None else jpresets.parse_policy(spec))
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    tcfg = dataclasses.replace(
        tregistry.get_config("qwen3-14b", smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32,
        use_flash_kernel=flash)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    return (pj, jcfg), (pt, tcfg), toks


def _akeys(spec):
    if spec is None:
        return None, None
    return jax.random.key(AKEY), prng.key(AKEY)


@functools.lru_cache(maxsize=None)
def _jax_prefill(spec, flash):
    (pj, jcfg), _, toks = _pair(spec, flash)
    return jE.prefill(pj, jnp.asarray(toks, jnp.int32), jcfg,
                      max_seq=MAX_SEQ, akey=_akeys(spec)[0])


def _port_prefill(spec, flash):
    _, (pt, tcfg), toks = _pair(spec, flash)
    with torch.no_grad():
        return tE.prefill(pt, torch.as_tensor(toks), tcfg, max_seq=MAX_SEQ,
                          akey=_akeys(spec)[1])


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("spec", SPECS)
def test_prefill_logits_match_jax(spec, flash):
    lj, cj = _jax_prefill(spec, flash)
    lt, ct = _port_prefill(spec, flash)
    assert lt.shape == lj.shape == (2, 1, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    assert ct["k"].shape == (2, 2, MAX_SEQ, 2, 16)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]),
                               rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("spec", SPECS)
def test_serve_step_logits_match_jax(spec, flash):
    (pj, jcfg), (pt, tcfg), toks = _pair(spec, flash)
    _, cj = _jax_prefill(spec, flash)
    _, ct = _port_prefill(spec, flash)
    jk, tk = _akeys(spec)
    lj, _ = jE.serve_step(pj, jnp.asarray(toks[:, -1:], jnp.int32), cj,
                          jcfg, akey=jE.decode_step_key(jk, 0))
    with torch.no_grad():
        lt, nt = tE.serve_step(pt, torch.as_tensor(toks[:, -1:]), ct, tcfg,
                               akey=tE.decode_step_key(tk, 0))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    assert nt["pos"].tolist() == [9, 9]


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("spec", SPECS)
def test_greedy_tokens_match_jax(spec, flash):
    (pj, jcfg), (pt, tcfg), toks = _pair(spec, flash)
    jk, tk = _akeys(spec)
    oj, _ = jE.greedy_generate(pj, jnp.asarray(toks, jnp.int32), jcfg,
                               n_steps=N_STEPS, max_seq=MAX_SEQ, akey=jk)
    with torch.no_grad():
        ot, _ = tE.greedy_generate(pt, torch.as_tensor(toks), tcfg,
                                   n_steps=N_STEPS, max_seq=MAX_SEQ,
                                   akey=tk)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_flash_kernel_matches_fallback():
    """``use_flash_kernel`` reproduces the chunked fallback's logits
    (mirrors tests/test_flash_attention.py's model test), here over a
    150-token prompt: two softmax blocks of 128 with padding."""
    cfg = dataclasses.replace(tregistry.get_config("qwen3_14b", smoke=True),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    params = tT.init_lm(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 150)))
    outs = []
    for flash in FLASH:
        c = dataclasses.replace(cfg, use_flash_kernel=flash)
        with torch.no_grad():
            logits, cache = tE.prefill(params, toks, c, max_seq=160)
        outs.append((logits, cache))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               rtol=2e-4, atol=2e-4)
    # layer 0's keys precede any attention; layer 1's follow it
    assert torch.equal(outs[1][1]["k"][0], outs[0][1]["k"][0])
    np.testing.assert_allclose(outs[1][1]["k"].numpy(),
                               outs[0][1]["k"].numpy(), rtol=2e-4, atol=2e-4)


def test_qk_norm_params_carried():
    """q_norm / k_norm are per-layer ``{"scale": (d_head,)}`` dicts: they
    cross over as digital tensors and stay out of the analog conversion."""
    (pj, _), (pt, tcfg), _ = _pair(TWO_PHASE, False)
    for li in range(tcfg.n_layers):
        attn = pt["layers"][li]["attn"]
        for name in ("q_norm", "k_norm"):
            assert set(attn[name]) == {"scale"}
            np.testing.assert_array_equal(
                attn[name]["scale"].numpy(),
                np.asarray(pj["layers"]["attn"][name]["scale"])[li])
    own = tT.init_lm(0, tcfg, device="cpu")
    assert own["layers"][0]["attn"]["q_norm"]["scale"].shape == (16,)
    assert isinstance(own["layers"][0]["attn"]["q"], TState)


def test_converted_sites_and_seeds_match_jax():
    """7 * 2 + 1 analog sites at smoke size, each a tile whose device seed
    equals the JAX package's."""
    (pj, _), (pt, tcfg), _ = _pair(TWO_PHASE, False)
    tiles = [st for layer in pt["layers"] for blk, name in SITES
             for st in (layer[blk][name],)]
    assert all(isinstance(st, TState) for st in tiles)
    assert len(tiles) + 1 == 7 * tcfg.n_layers + 1
    own = tT.init_lm(0, tcfg, device="cpu")
    for blk, name in SITES:
        seeds = np.asarray(jax.random.key_data(pj["layers"][blk][name].seed))
        for li in range(tcfg.n_layers):
            assert own["layers"][li][blk][name].seed == tuple(
                int(v) for v in seeds[li])
    assert own["unembed"].seed == tuple(
        int(v) for v in np.asarray(jax.random.key_data(pj["unembed"].seed)))


def test_full_depth_site_seeds_match_jax():
    """All 281 = 7 * 40 + 1 analog sites of the published qwen3_14b get the
    JAX package's tile seeds: both conversions run on a skeleton of the
    model's tree (its paths and depth, 2 x 2 weights) under init_lm's
    conversion key."""
    n = tregistry.get_config("qwen3_14b").n_layers
    assert n == 40

    def layer(zeros):
        return {"attn": {nm: {"w": zeros()} for nm in "qkvo"}
                | {"q_norm": {"scale": zeros()[0]},
                   "k_norm": {"scale": zeros()[0]}},
                "mlp": {nm: {"w": zeros()} for nm in ("wi", "wg", "wo")}}

    jtree = {"layers": layer(lambda: jnp.zeros((n, 2, 2))),
             "unembed": {"w": jnp.zeros((2, 2))}}
    jtiles, _ = jconvert.convert_to_analog(
        jtree, None, jpresets.parse_policy(TWO_PHASE),
        key=jax.random.split(jax.random.key(0), 6)[5],
        normalize=JRPUConfig.normalized_for_lm)
    ttree = {"layers": [layer(lambda: torch.zeros(2, 2)) for _ in range(n)],
             "unembed": {"w": torch.zeros(2, 2)}}
    ttiles = tconvert.convert_to_analog(
        ttree, tpresets.parse_policy(TWO_PHASE),
        key=prng.split(prng.key(0), 6)[5],
        normalize=TRPUConfig.normalized_for_lm)
    count = 1
    for blk, name in SITES:
        seeds = np.asarray(jax.random.key_data(jtiles["layers"][blk][name]
                                               .seed))
        assert seeds.shape[0] == n
        for li in range(n):
            assert ttiles["layers"][li][blk][name].seed == tuple(
                int(v) for v in seeds[li])
            count += 1
    assert ttiles["unembed"].seed == tuple(int(v) for v in np.asarray(
        jax.random.key_data(jtiles["unembed"].seed)))
    assert count == 281
