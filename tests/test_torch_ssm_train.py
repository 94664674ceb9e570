"""Training the ssm family: the port's LM trainer on mamba2_130m against the
JAX package's, at the smoke size (2 SSD layers, d 64, tied embeddings,
vocab 256; batch 2, seq 32), float32 parameters.  The JAX side runs as the
JAX package's tests run it (jit on the CPU, ``use_pallas`` off); the port
starts from the JAX package's weights and tile seeds (``from_jax_params``)
and runs the plain versions of its kernels.

* the digital ``loss_fn`` and its gradients: loss at rtol 1e-5, every
  gradient leaf (the SSD block's ``A_log``, ``D``, ``dt_bias``, ``conv_w``
  and norm included) at rtol 1e-4 and atol 1e-5;
* one analog ``make_train_step`` (remat on) from JAX's weights on both
  projection routes under both BM modes: the single-shot route
  (``lm_managed``, update management on) under two-phase BM (``SINGLE_2P``,
  the port on its fused backward+update route) and the paper's iterative
  BM (``SINGLE_IT``), and the temporal route of the SSD projections
  (``TEMPORAL``: ``nm_bm``, no update management, one read per position
  and one accumulated update per tile; ``in_proj`` under iterative BM,
  ``out_proj`` under two-phase BM on the port's fused temporal cycle; the
  other tiles single-shot, iterative).  The loss within
  LOSS_ATOL (1e-5) and each tile's new weights held as
  ``test_torch_lm_train.py`` holds them: at most MAX_MOVED_SHARE (1e-3) of
  a tile's entries beyond WEIGHT_ATOL (1e-6), none beyond DW_BOUND (3e-3),
  every tile moved (an activation an ulp off can flip a Bernoulli draw at
  ``u ~ p``);
* the scan engine bitwise the python loop on the CPU (2 steps: params,
  optimizer state, losses) under ``SINGLE_2P`` and ``TEMPORAL`` on the
  kernels' plain versions;
* the CLI trains 2 steps on the CPU;
* a JAX checkpoint of ``(params, opt_state)`` restores into the port
  bitwise, and the port's restores into the JAX package's store bitwise.

The JAX programs compiled here are four, each once (``lru_cache``): the
digital gradients and the three analog steps.  ``test_torch_hybrid_train.
py`` runs the same checks on hymba_1_5b through this file's helpers.
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

ARCH = "mamba2_130m"
B, S = 2, 32
SINGLE_2P = "lm_managed:bm_mode=two_phase"
SINGLE_IT = "lm_managed"
TEMPORAL = "*in_proj=nm_bm,*out_proj=nm_bm:bm_mode=two_phase,*=lm_managed"
SPECS = [SINGLE_2P, SINGLE_IT, TEMPORAL]
SPEC_IDS = ["single_two_phase", "single_iterative", "temporal"]
# the port's routes of the same device settings: the kernels' plain
# versions, two-phase tiles on the fused backward+update route (single-shot
# and temporal); an iterative tile is not eligible and keeps its cycles
PORT_KNOBS = dict(use_pallas=True, fuse_bwd_update=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(arch, spec=None):
    kw = dict(param_dtype=jnp.float32)
    if spec is not None:
        kw.update(analog_policy=jpresets.parse_policy(spec))
    return dataclasses.replace(jregistry.get_config(arch, smoke=True), **kw)


def port_cfg(arch, spec=None):
    kw = dict(param_dtype=torch.float32)
    if spec is not None:
        kw.update(analog_policy=tpresets.parse_policy(spec))
    return dataclasses.replace(tregistry.get_config(arch, smoke=True), **kw)


def tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def jax_params(arch, spec=None):
    """The JAX package's initial params (key 0) under ``spec``."""
    return jT.init_lm(jax.random.key(0), jax_cfg(arch, spec))[0]


@functools.lru_cache(maxsize=None)
def _jax_digital(arch):
    pj = jax_params(arch)
    fn = jax.jit(jax.grad(lambda p: jlm.loss_fn(
        p, {"tokens": jnp.asarray(tokens())}, jax_cfg(arch)),
        has_aux=True))
    return fn(pj)


@functools.lru_cache(maxsize=None)
def _jax_analog_step(arch, spec):
    pj = jax_params(arch, spec)
    step, opt = jlm.make_train_step(jax_cfg(arch, spec))
    pj2, _, mj = jax.jit(step)(pj, opt.init(pj), {"tokens": jnp.asarray(
        tokens())}, jax.random.key(5))
    return pj2, float(mj["loss"])


def check_digital(arch):
    gj, mj = _jax_digital(arch)
    pt = from_jax_params(numpy_tree(jax_params(arch)), device="cpu")
    ws = [t.requires_grad_() for t, _ in topt.leaves(pt)]
    total, mt = tlm.loss_fn(pt, {"tokens": torch.from_numpy(tokens())},
                            port_cfg(arch))
    gt = topt.grad_tree(pt, torch.autograd.grad(total, ws))
    np.testing.assert_allclose(float(mt["loss"].detach()), float(mj["loss"]),
                               rtol=1e-5)
    assert_trees_close(gt, gj, 1e-4, atol=1e-5)
    names = {k.split("/")[-1] for k, _ in tstore._flatten_with_paths(
        stack_layers(gt))}
    assert {"A_log", "D", "dt_bias", "conv_w"} <= names


def check_analog_step(arch, spec, n_tiles):
    pj = jax_params(arch, spec)
    pj2, loss_j = _jax_analog_step(arch, spec)
    tcfg = port_cfg(arch, spec)
    assert tcfg.remat
    pt = with_knobs(from_jax_params(numpy_tree(pj), device="cpu"),
                    **PORT_KNOBS)
    step, opt = tlm.make_train_step(tcfg)
    pt, _, mt = step(pt, opt.init(pt), {"tokens": torch.from_numpy(
        tokens())}, prng.key(5))
    assert abs(float(mt["loss"]) - loss_j) <= LOSS_ATOL
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=lambda n: isinstance(n, JState))
    j0, jt = leaves(pj), leaves(pj2)
    tiles = [(i, n) for i, n in enumerate(jt) if isinstance(n, JState)]
    got = list(_tiles(stack_layers(pt)))
    assert len(tiles) == len(got) == n_tiles
    for (i, want), tile in zip(tiles, got):
        new = tile.w.detach().numpy()
        diff = np.abs(new - np.asarray(want.w))
        assert np.sum(new != np.asarray(j0[i].w)) > 0, i
        assert (diff > WEIGHT_ATOL).mean() <= MAX_MOVED_SHARE, i
        assert diff.max() <= DW_BOUND, i


def assert_bitwise(a, b):
    la = tstore._flatten_with_paths(stack_layers(a))
    lb = tstore._flatten_with_paths(stack_layers(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert type(x) is type(y), k


def check_engines(arch, spec):
    runs = {engine: ttrain.train(
        arch, steps=2, batch=B, seq=S, smoke=True, analog_policy=spec,
        use_pallas=True, fuse_bwd_update=True, engine=engine, scan_chunk=2,
        device="cpu", verbose=False, return_params=True)
        for engine in ("scan", "python")}
    scan, loop = runs["scan"], runs["python"]
    assert scan["losses"] == loop["losses"] and len(scan["losses"]) == 2
    assert all(np.isfinite(scan["losses"]))
    assert_bitwise((scan["params"], scan["opt_state"]),
                   (loop["params"], loop["opt_state"]))


def check_cli(arch, capsys):
    ttrain.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--analog-policy", "*ssm*=nm_bm",
                 "--use-pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] resolved analog policy" in out
    assert "layers/ssm/in_proj" in out
    assert f"[train {arch}] step 1 loss" in out
    assert "on cpu, engine scan" in out


def test_digital_loss_and_grads_match_jax():
    check_digital(ARCH)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_analog_step_matches_jax(spec):
    check_analog_step(ARCH, spec, n_tiles=2)


@pytest.mark.parametrize("spec", [SINGLE_2P, TEMPORAL],
                         ids=["single_two_phase", "temporal"])
def test_scan_engine_is_the_loop_bitwise(spec):
    check_engines(ARCH, spec)


def test_cli_trains_on_the_cpu(capsys):
    check_cli(ARCH, capsys)


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
    pj = jax_params(ARCH, SINGLE_2P)
    jo = jlm.default_optimizer(jax_cfg(ARCH, SINGLE_2P))
    # a state that is not all zeros: one AdamW step on the digital leaves
    pj, sj = jo.update(random_grads(pj, 4), jo.init(pj), pj)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jdir, 3, (pj, sj), {"arch": ARCH})

    tcfg = port_cfg(ARCH, SINGLE_2P)
    to = tlm.default_optimizer(tcfg)
    pt0 = tlm.init_train_state(9, tcfg, to, device="cpu")[0]
    like = stack_layers((pt0, to.init(pt0)))
    restored, meta = tstore.restore(jdir, 3, like)
    assert meta == {"arch": ARCH}
    pt, st = unstack_layers(restored, tcfg.n_layers)
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
    assert "A_log" in pt["layers"][1]["ssm"] and "unembed" not in pt

    tstore.save(tdir, 3, stack_layers((pt, st)), {"arch": ARCH})
    back, _ = jstore.restore(tdir, 3, (pj, sj))
    assert_trees_close_jax(back, (pj, sj))
