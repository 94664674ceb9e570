"""qwen1_5_110b and its QKV bias (``qkv_bias``): the port against the JAX
package at the smoke size (2 layers, d 64, 8 heads over 2 KV heads of 8,
d_ff 192, vocab 256), float32.

The JAX package's ``init_lm`` parameters, their zero biases ``qb``, ``kb``
and ``vb`` replaced by seeded normals (std 0.5, so that a bias that is
dropped or added twice shows), go through ``from_jax_params``; the two
packages then run ``forward``, ``greedy_generate`` and one analog training
step from the same weights, tokens and keys, digital and under the noisy
``lm_managed`` (iterative BM on the reference reads).

Tolerances: ``LOGIT_ATOL`` (1e-4, ``test_torch_serve.py``) absolute on
logits and on every cache leaf; greedy tokens equal; the training step as
``test_torch_lm_train.py`` holds it (the loss within 1e-5; a tile's
entries: at most 1e-3 beyond 1e-6, none beyond 3e-3, every tile moved)
and the bias leaves, trained by AdamW under ``mixed_analog``, and their
moments within 1e-4 of each leaf's largest entry.
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
from repro.train import lm as jlm
from repro_torch.analog.convert import from_jax_params, stack_layers
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.train import lm as tlm
from repro_torch.utils import prng

from test_torch_lm_train import (DW_BOUND, LOSS_ATOL, MAX_MOVED_SHARE,
                                 WEIGHT_ATOL, _tiles, assert_trees_close,
                                 numpy_tree, with_knobs)
from test_torch_serve import LOGIT_ATOL

ARCH = "qwen1_5_110b"
NOISY = "lm_managed"
SPECS = [None, NOISY]
TWO_PHASE = "lm_managed:bm_mode=two_phase"
AKEY, B, S, MAX_SEQ, N_STEPS = 7, 2, 24, 32, 5
BIASES = ("qb", "kb", "vb")
ADAM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_biases(pj, seed=3):
    """The JAX tree with its zero QKV biases replaced by seeded normals."""
    rng = np.random.default_rng(seed)
    attn = dict(pj["layers"]["attn"])
    for n in BIASES:
        attn[n] = jnp.asarray(rng.normal(0, 0.5, attn[n].shape),
                              attn[n].dtype)
    return {**pj, "layers": {**pj["layers"], "attn": attn}}


@functools.lru_cache(maxsize=None)
def _pair(spec, remat=False):
    jcfg = dataclasses.replace(
        jregistry.get_config(ARCH, smoke=True), param_dtype=jnp.float32,
        act_dtype=jnp.float32, remat=remat,
        analog_policy=None if spec is None else jpresets.parse_policy(spec))
    pj = _with_biases(jT.init_lm(jax.random.key(0), jcfg)[0])
    tcfg = dataclasses.replace(
        tregistry.get_config(ARCH, smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32, remat=remat)
    return (pj, jcfg), (from_jax_params(numpy_tree(pj), device="cpu"), tcfg)


def _toks(s=S):
    return np.random.default_rng(1).integers(0, 256, (B, s))


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
        assert t.qkv_bias and not t.kv_cache_quant and t.family == "dense"
    full = tregistry.get_config(ARCH)
    assert 90e9 <= full.param_count() <= 130e9
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.rope_theta) == (
        80, 8192, 64, 8, 49152, 152064, 1e6)
    assert tregistry.canonical("qwen1.5-110b") == ARCH


def test_init_makes_zero_biases():
    """Both initialisations, the port's own draw and the JAX package's
    (``jax_weights``), hold zero biases of the projections' widths, and
    the JAX draw is JAX's ``init_lm`` within 3 ulp, leaf for leaf."""
    cfg = dataclasses.replace(tregistry.get_config(ARCH, smoke=True),
                              param_dtype=torch.float32)
    for jw in (False, True):
        attn = tT.init_lm(3, cfg, device="cpu", jax_weights=jw)[
            "layers"][1]["attn"]
        assert [tuple(attn[n].shape) for n in BIASES] == [(64,), (16,),
                                                          (16,)]
        assert all(not attn[n].any() for n in BIASES)
    got = tstore._flatten_with_paths(stack_layers(tT.init_lm(
        3, cfg, device="cpu", jax_weights=True)))
    want = jstore._flatten_with_paths(jT.init_lm(
        jax.random.key(3), dataclasses.replace(
            jregistry.get_config(ARCH, smoke=True),
            param_dtype=jnp.float32))[0])[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert "layers/attn/kb" in [k for k, _ in got]
    for (k, a), (_, b) in zip(got, want):
        a, b = tstore._to_numpy(a), jstore._to_numpy(b)
        ulp = np.abs(a.view(np.int32).astype(np.int64)
                     - b.view(np.int32).astype(np.int64))
        assert a.shape == b.shape and ulp.max() <= 3, k


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_from_jax_params_takes_the_biases(spec):
    (pj, _), (pt, _) = _pair(spec)
    got = tstore._flatten_with_paths(stack_layers(pt))
    want = jstore._flatten_with_paths(pj)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(tstore._to_numpy(a),
                                      jstore._to_numpy(b), err_msg=k)
    for n in BIASES:
        assert float(pt["layers"][1]["attn"][n].abs().max()) > 0.1


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_forward_matches_jax(spec):
    (pj, jcfg), (pt, tcfg) = _pair(spec)
    jk, tk = _akeys(spec)
    lj, _ = jT.forward(pj, jnp.asarray(_toks(), jnp.int32), jcfg, akey=jk)
    with torch.no_grad():
        lt, _ = tT.forward(pt, torch.as_tensor(_toks()), tcfg, akey=tk)
    _close(lt.numpy(), lj)
    # the biases move the logits: without them the forward differs
    nob = {**pt, "layers": [{**lay, "attn": {k: v for k, v in
                                             lay["attn"].items()
                                             if k not in BIASES}}
                            for lay in pt["layers"]]}
    with torch.no_grad():
        l0, _ = tT.forward(nob, torch.as_tensor(_toks()), tcfg, akey=tk)
    assert float((l0 - lt).abs().max()) > 100 * LOGIT_ATOL


@pytest.mark.parametrize("spec", SPECS, ids=["digital", "noisy"])
def test_greedy_generate_matches_jax(spec):
    (pj, jcfg), (pt, tcfg) = _pair(spec)
    jk, tk = _akeys(spec)
    tj, cj = jE.greedy_generate(pj, jnp.asarray(_toks(), jnp.int32), jcfg,
                                n_steps=N_STEPS, max_seq=MAX_SEQ, akey=jk)
    with torch.no_grad():
        tt, ct = tE.greedy_generate(pt, torch.as_tensor(_toks()), tcfg,
                                    n_steps=N_STEPS, max_seq=MAX_SEQ,
                                    akey=tk)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert set(ct) == set(cj)
    for k in cj:
        assert tuple(ct[k].shape) == tuple(cj[k].shape), k
        _close(ct[k].numpy(), cj[k], k)


@functools.lru_cache(maxsize=None)
def _jax_analog_step():
    (pj, jcfg), _ = _pair(TWO_PHASE, remat=True)
    step, opt = jlm.make_train_step(jcfg)
    batch = {"tokens": jnp.asarray(_toks(32), jnp.int32)}
    return jax.jit(step)(pj, opt.init(pj), batch, jax.random.key(5))


def test_analog_step_matches_jax():
    """One ``make_train_step`` under two-phase BM (the port on its fused
    route, JAX on its separate cycles): tiles as the LM test holds them,
    the bias leaves and their AdamW moments close to JAX's."""
    (pj, _), (pt, tcfg) = _pair(TWO_PHASE, remat=True)
    pj2, sj2, mj = _jax_analog_step()
    pt = with_knobs(from_jax_params(numpy_tree(pj), device="cpu"),
                    use_pallas=True, fuse_bwd_update=True)
    step, opt = tlm.make_train_step(tcfg)
    pt, st, mt = step(pt, opt.init(pt), {"tokens": torch.as_tensor(
        _toks(32))}, prng.key(5))
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_ATOL
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=lambda n: isinstance(n, JState))
    j0, jt = leaves(pj), leaves(pj2)
    tiles = [(i, n) for i, n in enumerate(jt) if isinstance(n, JState)]
    got = list(_tiles(stack_layers(pt)))
    assert len(tiles) == len(got) == 8      # 7 stacked sites + unembed
    for (i, want), tile in zip(tiles, got):
        new = tile.w.detach().numpy()
        diff = np.abs(new - np.asarray(want.w))
        assert np.sum(new != np.asarray(j0[i].w)) > 0, i
        assert (diff > WEIGHT_ATOL).mean() <= MAX_MOVED_SHARE, i
        assert diff.max() <= DW_BOUND, i
    pick = lambda tree: {n: tree["layers"]["attn"][n]  # noqa: E731
                         for n in BIASES}
    tb = stack_layers(pt)["layers"]["attn"]
    for n in BIASES:
        new = tb[n].numpy()
        want = np.asarray(pick(pj2)[n])
        assert not np.array_equal(new, np.asarray(pick(pj)[n])), n
        np.testing.assert_allclose(new, want, rtol=0,
                                   atol=ADAM_RTOL * np.abs(want).max(),
                                   err_msg=n)
    assert int(st["count"]) == int(sj2["count"]) == 1
    assert_trees_close({k: st[k] for k in ("mu", "nu")},
                       {k: sj2[k] for k in ("mu", "nu")}, ADAM_RTOL,
                       scaled=True)
    assert float(st["mu"]["layers"][0]["attn"]["qb"].abs().max()) > 0


def test_cross_decode_adds_the_q_bias():
    """The encoder-decoder with ``qkv_bias`` (a config no registry entry
    has; both packages take it): a decode step's cross attention reads q
    alone and adds ``qb``; prefill and decode logits and every cache leaf
    against JAX's, biases seeded on every attention."""
    over = dict(qkv_bias=True, remat=False)
    jcfg = dataclasses.replace(
        jregistry.get_config("seamless_m4t_medium", smoke=True),
        param_dtype=jnp.float32, act_dtype=jnp.float32, **over)
    pj = jT.init_lm(jax.random.key(0), jcfg)[0]
    rng = np.random.default_rng(4)
    for stack, part in (("layers", "attn"), ("layers", "cross"),
                        ("enc_layers", "attn")):
        blk = dict(pj[stack][part])
        for n in BIASES:
            blk[n] = jnp.asarray(rng.normal(0, 0.5, blk[n].shape),
                                 jnp.float32)
        pj = {**pj, stack: {**pj[stack], part: blk}}
    tcfg = dataclasses.replace(
        tregistry.get_config("seamless_m4t_medium", smoke=True),
        param_dtype=torch.float32, act_dtype=torch.float32, **over)
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    assert float(pt["layers"][0]["cross"]["qb"].abs().max()) > 0.1
    frames = rng.normal(0, 0.5, (B, 10, 64)).astype(np.float32)
    tj, cj = jE.greedy_generate(pj, jnp.asarray(_toks(), jnp.int32), jcfg,
                                n_steps=N_STEPS, max_seq=MAX_SEQ,
                                enc_embeds=jnp.asarray(frames))
    with torch.no_grad():
        tt, ct = tE.greedy_generate(pt, torch.as_tensor(_toks()), tcfg,
                                    n_steps=N_STEPS, max_seq=MAX_SEQ,
                                    enc_embeds=torch.from_numpy(frames))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    for k in cj:
        _close(ct[k].numpy(), cj[k], k)
    lj, _ = jE.serve_step(pj, jnp.asarray(tj[:, -1:]), cj, jcfg)
    with torch.no_grad():
        lt, _ = tE.serve_step(pt, tt[:, -1:], ct, tcfg)
    _close(lt.numpy(), lj)
