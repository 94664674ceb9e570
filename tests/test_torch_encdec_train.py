"""Training the encoder-decoder (seamless_m4t_medium, family ``audio``): the
port's LM trainer against the JAX package's at the smoke size (2 encoder
and 2 decoder layers, d 64, 4 heads, vocab 256; batch 2, seq 32, 16 stub
frames), float32 parameters.  The JAX side runs as the JAX package's tests
run it (jit on the CPU, ``use_pallas`` off); the port starts from the JAX
package's weights and tile seeds (``from_jax_params``) and runs the plain
versions of its kernels.

* the trainer's batch: ``_build_batch``'s leaves equal the JAX trainer's in
  shape, dtype and value, for one step and for an engine chunk;
* ``loss_fn`` with ``enc_embeds`` (seeded normals): digital, the loss at
  rtol 1e-5 and every gradient leaf (the encoder's, the cross attention's
  and the adapter's included) at rtol 1e-4, atol 1e-5; under the noisy
  ``lm_managed`` reads (iterative BM) the loss within LOSS_ATOL (1e-5);
* one analog ``make_train_step`` (remat on: the encoder's layers and the
  decoder's blocks recomputed in the backward) from JAX's weights under
  two-phase BM (the port on its fused backward+update route, held against
  JAX's separate cycles) and the paper's iterative BM: the loss within
  LOSS_ATOL; each of the 20 stacked tiles (the encoder's 7 sites, the
  decoder's 11 with the cross attention's, the adapter and the unembed;
  38 tiles over the layers) as ``test_torch_lm_train.py``
  holds them (at most 1e-3 of a tile's entries beyond 1e-6, none beyond
  3e-3, every tile moved); the AdamW state of the digital leaves (embed,
  norms) within ADAM_RTOL (1e-4) of each leaf's largest entry, its count
  equal;
* the scan engine bitwise the python loop on the CPU (2 steps: params,
  optimizer state, losses), the stub frames a leaf of each chunk;
* the CLI ``--arch seamless_m4t_medium --smoke`` trains, checkpoints and
  resumes on the CPU;
* a JAX checkpoint of an encoder-decoder train state restores into the
  port bitwise, and the port's restores into the JAX store bitwise.

Four JAX programs are compiled here, each once.
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
from repro.launch import train as jtrain
from repro.models import transformer as jT
from repro.train import lm as jlm
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import (from_jax_opt_state, from_jax_params,
                                        stack_layers, unstack_layers)
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.train import lm as tlm
from repro_torch.utils import prng

from test_torch_lm_train import (DW_BOUND, LOSS_ATOL, MAX_MOVED_SHARE,
                                 WEIGHT_ATOL, _tiles, assert_trees_close,
                                 assert_trees_close_jax, numpy_tree,
                                 random_grads, with_knobs)

ARCH = "seamless_m4t_medium"
B, S, S_SRC = 2, 32, 16
TWO_PHASE = "lm_managed:bm_mode=two_phase"
ITERATIVE = "lm_managed"
PORT_KNOBS = {TWO_PHASE: dict(use_pallas=True, fuse_bwd_update=True),
              ITERATIVE: dict(use_pallas=True)}
ADAM_RTOL = 1e-4
N_TILES = 7 + 11 + 2           # stacked: encoder, decoder, adapter, unembed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(spec=None):
    kw = dict(param_dtype=jnp.float32)
    if spec is not None:
        kw.update(analog_policy=jpresets.parse_policy(spec))
    return dataclasses.replace(jregistry.get_config(ARCH, smoke=True), **kw)


def port_cfg(spec=None):
    kw = dict(param_dtype=torch.float32)
    if spec is not None:
        kw.update(analog_policy=tpresets.parse_policy(spec))
    return dataclasses.replace(tregistry.get_config(ARCH, smoke=True), **kw)


def batch_np(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, S)).astype(np.int32),
            rng.normal(0, 0.5, (B, S_SRC, 64)).astype(np.float32))


def jax_batch():
    toks, frames = batch_np()
    return {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(frames)}


def port_batch():
    toks, frames = batch_np()
    return {"tokens": torch.from_numpy(toks),
            "enc_embeds": torch.from_numpy(frames)}


@functools.lru_cache(maxsize=None)
def jax_params(spec=None):
    return jT.init_lm(jax.random.key(0), jax_cfg(spec))[0]


@functools.lru_cache(maxsize=None)
def _jax_digital():
    fn = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, jax_batch(), jax_cfg()),
                          has_aux=True))
    return fn(jax_params())


@functools.lru_cache(maxsize=None)
def _jax_analog_step(spec):
    pj = jax_params(spec)
    step, opt = jlm.make_train_step(jax_cfg(spec))
    return jax.jit(step)(pj, opt.init(pj), jax_batch(), jax.random.key(5))


@pytest.mark.parametrize("lead", [(B,), (3, B)], ids=["step", "chunk"])
def test_build_batch_is_the_jax_trainers(lead):
    toks = np.random.default_rng(0).integers(0, 256, (*lead, S)).astype(
        np.int32)
    for smoke in (True, False):
        want = jtrain._build_batch(jregistry.get_config(ARCH, smoke=smoke),
                                   jnp.asarray(toks), S)
        got = ttrain._build_batch(tregistry.get_config(ARCH, smoke=smoke),
                                  torch.from_numpy(toks), S)
        assert set(got) == set(want) == {"tokens", "enc_embeds"}
        for k in want:
            a, b = tstore._to_numpy(got[k]), jstore._to_numpy(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert got["enc_embeds"].shape == (*lead, max(S // 2, 8), 1024)
    dense = ttrain._build_batch(tregistry.get_config("deepseek_7b"),
                                torch.from_numpy(toks), S)
    assert set(dense) == {"tokens"}


def test_digital_loss_and_grads_match_jax():
    gj, mj = _jax_digital()
    pt = from_jax_params(numpy_tree(jax_params()), device="cpu")
    ws = [t.requires_grad_() for t, _ in topt.leaves(pt)]
    total, mt = tlm.loss_fn(pt, port_batch(), port_cfg())
    gt = topt.grad_tree(pt, torch.autograd.grad(total, ws))
    np.testing.assert_allclose(float(mt["loss"].detach()), float(mj["loss"]),
                               rtol=1e-5)
    assert_trees_close(gt, gj, 1e-4, atol=1e-5)
    enc = gt["enc_layers"][1]["attn"]["q"]["w"]
    assert float(enc.abs().max()) > 0        # the encoder takes a gradient


def test_noisy_loss_matches_jax():
    pj = jax_params(ITERATIVE)
    _, mj = jax.jit(lambda p: jlm.loss_fn(p, jax_batch(), jax_cfg(ITERATIVE),
                                          jax.random.key(5)))(pj)
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    with torch.no_grad():
        _, mt = tlm.loss_fn(pt, port_batch(), port_cfg(ITERATIVE),
                            prng.key(5))
        _, m_other = tlm.loss_fn(pt, port_batch(), port_cfg(ITERATIVE),
                                 prng.key(6))
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_ATOL
    # the reads are noisy: another key gives another loss
    assert float(m_other["loss"]) != float(mt["loss"])


@pytest.mark.parametrize("spec", [TWO_PHASE, ITERATIVE],
                         ids=["two_phase", "iterative"])
def test_analog_step_matches_jax(spec):
    pj = jax_params(spec)
    pj2, sj2, mj = _jax_analog_step(spec)
    tcfg = port_cfg(spec)
    assert tcfg.remat
    pt = with_knobs(from_jax_params(numpy_tree(pj), device="cpu"),
                    **PORT_KNOBS[spec])
    step, opt = tlm.make_train_step(tcfg)
    pt, st, mt = step(pt, opt.init(pt), port_batch(), prng.key(5))
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_ATOL
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=lambda n: isinstance(n, JState))
    j0, jt = leaves(pj), leaves(pj2)
    tiles = [(i, n) for i, n in enumerate(jt) if isinstance(n, JState)]
    got = list(_tiles(stack_layers(pt)))
    assert len(tiles) == len(got) == N_TILES
    for (i, want), tile in zip(tiles, got):
        new = tile.w.detach().numpy()
        diff = np.abs(new - np.asarray(want.w))
        assert np.sum(new != np.asarray(j0[i].w)) > 0, i
        assert (diff > WEIGHT_ATOL).mean() <= MAX_MOVED_SHARE, i
        assert diff.max() <= DW_BOUND, i
    # AdamW on the digital leaves: moments close, count equal, a tile's
    # moments rank-0 sentinels in both
    assert int(st["count"]) == int(sj2["count"]) == 1
    assert_trees_close({k: st[k] for k in ("mu", "nu")},
                       {k: sj2[k] for k in ("mu", "nu")}, ADAM_RTOL,
                       scaled=True)
    assert float(st["mu"]["embed"]["table"].abs().max()) > 0


def test_scan_engine_is_the_loop_bitwise():
    runs = {engine: ttrain.train(
        ARCH, steps=2, batch=B, seq=S, smoke=True, analog_policy=TWO_PHASE,
        use_pallas=True, fuse_bwd_update=True, engine=engine, scan_chunk=2,
        device="cpu", verbose=False, return_params=True)
        for engine in ("scan", "python")}
    scan, loop = runs["scan"], runs["python"]
    assert scan["losses"] == loop["losses"] and len(scan["losses"]) == 2
    assert all(np.isfinite(scan["losses"]))
    la = tstore._flatten_with_paths(stack_layers((scan["params"],
                                                  scan["opt_state"])))
    lb = tstore._flatten_with_paths(stack_layers((loop["params"],
                                                  loop["opt_state"])))
    assert [k for k, _ in la] == [k for k, _ in lb]
    assert any(k.startswith("0/enc_layers/") for k, _ in la)
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
            "--analog-policy", TWO_PHASE, "--use-pallas",
            "--fuse-bwd-update", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--scan-chunk", "2", "--device", "cpu"]
    ttrain.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "enc_layers/attn/q" in out and "adapter" in out
    assert f"[train {ARCH}] step 1 loss" in out
    assert "on cpu, engine scan" in out
    assert tstore.latest_step(str(tmp_path / "ck")) == 2
    ttrain.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    assert f"[train {ARCH}] step 2 loss" in out


def test_train_state_round_trips_the_jax_store(tmp_path):
    pj = jax_params(TWO_PHASE)
    jo = jlm.default_optimizer(jax_cfg(TWO_PHASE))
    # a state that is not all zeros: one AdamW step on the digital leaves
    pj, sj = jo.update(random_grads(pj, 4), jo.init(pj), pj)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jdir, 3, (pj, sj), {"arch": ARCH})

    tcfg = port_cfg(TWO_PHASE)
    to = tlm.default_optimizer(tcfg)
    pt0 = tlm.init_train_state(9, tcfg, to, device="cpu")[0]
    like = stack_layers((pt0, to.init(pt0)))
    restored, meta = tstore.restore(jdir, 3, like)
    assert meta == {"arch": ARCH}
    pt, st = unstack_layers(restored, tcfg.n_layers, tcfg.encoder_layers)
    want_p = from_jax_params(numpy_tree(pj), device="cpu")
    want_s = from_jax_opt_state(numpy_tree(sj), device="cpu")
    got, want = (tstore._flatten_with_paths(t)
                 for t in ((pt, st), (want_p, want_s)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k
    assert len(pt["enc_layers"]) == 2 and "adapter" in pt
    assert "enc_norm" in st["mu"] and "adapter" in st["nu"]

    tstore.save(tdir, 3, stack_layers((pt, st)), {"arch": ARCH})
    back, _ = jstore.restore(tdir, 3, (pj, sj))
    assert_trees_close_jax(back, (pj, sj))
