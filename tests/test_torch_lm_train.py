"""The port's LM training path (``repro_torch.train.lm``, ``optim``,
``analog/convert.py``'s LM trees, the LM checkpoint layout and the
``launch/train.py`` driver) against the JAX package's, at the deepseek_7b
smoke size (2 layers, d 64, vocab 256; batch 2, seq 32).  The JAX side runs
as the JAX package's tests run it: jit on the CPU, ``use_pallas`` off; the
port's parameters and optimizer states come from the JAX package's through
``from_jax_params`` / ``from_jax_opt_state``.

* ``adamw``, ``momentum``, ``mixed_analog(adamw)``, ``sgd`` and
  ``analog_sgd``: 3 steps on a tree
  that holds analog tiles, at rtol 1e-6 (XLA contracts ``a * b + c`` into
  one fused multiply-add on the CPU, torch rounds twice; an entry that a
  step nearly cancels is held at 1e-6 of its leaf's largest); the state trees
  match leaf for leaf, path for path, sentinels included; a bfloat16
  digital step matches within bfloat16's ulp;
* the digital ``loss_fn`` and its gradients: loss at rtol 1e-5, gradients
  at rtol 1e-4 and atol 1e-5 (the recurrent tests' bounds);
* one analog ``make_train_step`` with remat on, under two-phase BM (the
  port on its fused backward+update route) and the paper's iterative BM:
  the loss within LOSS_ATOL, and each tile's new weights held entry by
  entry as the LeNet test holds them (an activation an ulp off can flip a
  Bernoulli draw at ``u ~ p``): at most MAX_MOVED_SHARE of a tile's
  entries beyond WEIGHT_ATOL, none beyond DW_BOUND, every tile moved;
* a JAX LM checkpoint of ``(params, opt_state)`` restores into the port
  bitwise, and the port's restores into the JAX package's store bitwise;
* ``init_lm(jax_weights=True)`` is the JAX package's initial draw;
* the seeded device maps' normals drawn on a card (``prng.
  normal_on_device``) are JAX's threefry bits bitwise and its normals
  within 3 ulp, as the host draw is;
* the training forward with the flash kernel raises in both packages; the
  driver's refusals carry the JAX driver's messages, and its ``--lr``
  default is the JAX CLI's.

The port-only checks (remat, engines, resume) are in
``test_torch_lm_engine.py``; the token pipeline in ``test_torch_tokens.py``.

``python tests/test_torch_lm_train.py --write-bands`` remakes
``src/repro_torch/benchmarks/jax_lm_bands.json`` (the JAX package's
``analog_lm_convergence`` runs at seeds 0-2, one process each); pytest
never runs it.
"""

import dataclasses
import functools
import inspect
import os

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
from repro.optim import optimizers as jopt
from repro.train import lm as jlm
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import (from_jax_opt_state, from_jax_params,
                                        stack_layers, unstack_layers)
from repro_torch.analog.modules import AnalogState
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.train import lm as tlm
from repro_torch.utils import prng

B, S = 2, 32
TWO_PHASE = "lm_managed:bm_mode=two_phase"
ITERATIVE = "lm_managed"
# the port's routes of the same device settings: the kernels' plain
# versions, two-phase BM on the fused backward+update route
PORT_KNOBS = {TWO_PHASE: dict(use_pallas=True, fuse_bwd_update=True),
              ITERATIVE: dict(use_pallas=True)}
LOSS_ATOL = 1e-5
WEIGHT_ATOL = 1e-6
MAX_MOVED_SHARE = 1e-3
DW_BOUND = 3e-3
# relative to each leaf's largest entry: a step can cancel most of an entry
# (a small weight, a moment whose gradient changed sign)
OPT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    """A JAX param or optimizer-state tree as ``from_jax_params`` takes it
    (an optimizer state's tiles carry float sentinels for seeds)."""
    if isinstance(tree, JState):
        seed = tree.seed
        seed = (np.asarray(jax.random.key_data(seed))
                if jnp.issubdtype(seed.dtype, jax.dtypes.prng_key)
                else np.asarray(seed))
        node = {"w": np.asarray(tree.w), "seed": seed, "meta": tree.meta}
        if tree.maps is not None:
            node["maps"] = {f: np.asarray(getattr(tree.maps, f))
                            for f in ("dw_up", "dw_dn", "bound")}
        return node
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(numpy_tree(v) for v in tree)
    return np.asarray(tree)


def jax_cfg(spec=None, **kw):
    cfg = jregistry.get_config("deepseek_7b", smoke=True)
    if spec is not None:
        kw.update(analog_policy=jpresets.parse_policy(spec),
                  param_dtype=jnp.float32)
    return dataclasses.replace(cfg, **kw)


def port_cfg(spec=None, **kw):
    cfg = tregistry.get_config("deepseek_7b", smoke=True)
    if spec is not None:
        kw.update(analog_policy=tpresets.parse_policy(spec),
                  param_dtype=torch.float32)
    return dataclasses.replace(cfg, **kw)


def with_knobs(params, **knobs):
    """The port's tree with every tile's device config changed by
    ``knobs`` (the port's routes of the JAX settings)."""
    def walk(node):
        if isinstance(node, AnalogState):
            node.meta = dataclasses.replace(node.meta, cfg=dataclasses.replace(
                node.meta.cfg, **knobs))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    if knobs:
        walk(params)
    return params


def tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def flat(tree, stacked_port=False):
    """``(path, numpy)`` leaves in the JAX store's order."""
    if stacked_port:
        return [(k, tstore._to_numpy(v))
                for k, v in tstore._flatten_with_paths(tree)]
    return [(k, jstore._to_numpy(v))
            for k, v in jstore._flatten_with_paths(tree)[0]]


def assert_trees_close(port_tree, jax_tree, rtol, atol=0.0, equal=False,
                       scaled=False):
    """Leaf for leaf in the JAX store's order and paths; ``scaled``: each
    leaf also within ``rtol`` of its largest entry."""
    got = flat(stack_layers(port_tree), stacked_port=True)
    want = flat(jax_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if equal:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            top = float(np.abs(b).max()) if scaled and b.size else 0.0
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=rtol,
                                       atol=max(atol, rtol * top), err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_state(spec, **kw):
    """The JAX package's config and initial LM params (key 0)."""
    cfg = jax_cfg(spec, **kw)
    return cfg, jregistry_init(jax.random.key(0), cfg)[0]


def jregistry_init(key, cfg):
    from repro.models import transformer
    return transformer.init_lm(key, cfg)


def random_grads(params, seed):
    """A JAX grads tree for ``params``: normals on float leaves, float0 on
    a tile's seed (as ``jax.grad(allow_int=True)`` gives)."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if jnp.issubdtype(p.dtype, jax.dtypes.prng_key):
            return np.zeros(p.shape, jax.dtypes.float0)
        return jnp.asarray(0.01 * rng.standard_normal(p.shape), p.dtype)
    return jax.tree_util.tree_map(leaf, params)


def port_grads(jgrads):
    """The port's grads tree of a JAX grads tree (``None`` for seeds)."""
    def conv(node):
        if isinstance(node, JState):
            w = np.asarray(node.w)      # (layers, out, in) under a stack
            return {"w": w, "seed": np.zeros(w.shape[:-2] + (2,), np.uint32),
                    "meta": node.meta}
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return np.asarray(node)
    tree = from_jax_params(conv(jgrads), device="cpu")
    return topt.tree_map(lambda g: g if isinstance(g, torch.Tensor) else None,
                         tree)


OPTIMIZERS = {
    "adamw": (None, lambda m: m.adamw(3e-3, weight_decay=0.1)),
    "momentum": (TWO_PHASE, lambda m: m.momentum(3e-3, nesterov=True)),
    "mixed_adamw": (TWO_PHASE, lambda m: m.mixed_analog(m.adamw(3e-3))),
    "sgd": (TWO_PHASE, lambda m: m.sgd(3e-3)),
    "analog_sgd": (TWO_PHASE, lambda m: m.analog_sgd()),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    spec, make = OPTIMIZERS[name]
    jcfg, pj = jax_state(spec, param_dtype=jnp.float32)
    jo, to = make(jopt), make(topt)
    sj = jo.init(pj)
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    st = to.init(pt)
    topt.assert_scan_carry_safe(st)
    jopt.assert_scan_carry_safe(sj)
    # the initial states agree leaf for leaf, sentinels included
    assert_trees_close(st, sj, 0.0, equal=True)
    upd = jax.jit(jo.update)
    for i in range(3):
        gj = random_grads(pj, 10 + i)
        pj, sj = upd(gj, sj, pj)
        pt, st = to.update(port_grads(gj), st, pt)
    assert_trees_close(pt, pj, OPT_RTOL, scaled=True)
    assert_trees_close(st, sj, OPT_RTOL, scaled=True)
    if name == "mixed_adamw":
        # no moment is kept for a tile: its leaves are rank-0 sentinels
        q = st["mu"]["layers"][0]["attn"]["q"]
        assert q.w.shape == () and q.seed.shape == ()


def test_bf16_adamw_step_matches_within_an_ulp():
    jcfg, pj = jax_state(None)                  # bfloat16 params
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    assert pt["embed"]["table"].dtype == torch.bfloat16
    jo, to = jopt.adamw(1e-2), topt.adamw(1e-2)
    gj = random_grads(pj, 3)
    pj2, _ = jax.jit(jo.update)(gj, jo.init(pj), pj)
    pt2, st = to.update(port_grads(gj), to.init(pt), pt)
    assert int(st["count"]) == 1 and st["count"].dtype == torch.int32
    for (k, a), (_, b) in zip(flat(stack_layers(pt2), True), flat(pj2)):
        a32 = np.asarray(a.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32) if a.dtype == np.uint16 else a
        b32 = np.asarray(b.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32) if b.dtype == np.uint16 else b
        np.testing.assert_allclose(a32, b32, rtol=2.0 ** -7, atol=0,
                                   err_msg=k)


def _jax_loss_and_grads(jcfg, pj, toks, key):
    fn = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, {"tokens": toks}, jcfg,
                                                key), has_aux=True,
                          allow_int=True))
    return fn(pj)


def test_digital_loss_and_grads_match_jax():
    jcfg, pj = jax_state(None, param_dtype=jnp.float32)
    tcfg = port_cfg(None, param_dtype=torch.float32)
    toks = tokens()
    gj, mj = _jax_loss_and_grads(jcfg, pj, jnp.asarray(toks), None)
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    ws = [t.requires_grad_() for t, _ in topt.leaves(pt)]
    total, mt = tlm.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, tcfg)
    gt = topt.grad_tree(pt, torch.autograd.grad(total, ws))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    assert float(mt["aux"]) == 0.0
    assert_trees_close(gt, gj, 1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_analog_step(spec):
    jcfg, pj = jax_state(spec)
    step, opt = jlm.make_train_step(jcfg)
    pj2, _, mj = jax.jit(step)(pj, opt.init(pj), {"tokens": jnp.asarray(
        tokens())}, jax.random.key(5))
    return pj, pj2, float(mj["loss"])


@pytest.mark.parametrize("spec", [TWO_PHASE, ITERATIVE],
                         ids=["two_phase", "iterative"])
def test_analog_step_matches_jax(spec):
    pj, pj2, loss_j = _jax_analog_step(spec)
    tcfg = port_cfg(spec)
    assert tcfg.remat
    pt = with_knobs(from_jax_params(numpy_tree(pj), device="cpu"),
                    **PORT_KNOBS[spec])
    step, opt = tlm.make_train_step(tcfg)
    pt, _, mt = step(pt, opt.init(pt), {"tokens": torch.from_numpy(
        tokens())}, prng.key(5))
    assert abs(float(mt["loss"]) - loss_j) <= LOSS_ATOL
    jt = jax.tree_util.tree_leaves(
        pj2, is_leaf=lambda n: isinstance(n, JState))
    j0 = jax.tree_util.tree_leaves(
        pj, is_leaf=lambda n: isinstance(n, JState))
    tiles = [(i, n) for i, n in enumerate(jt) if isinstance(n, JState)]
    assert len(tiles) == 8                     # 7 stacked sites + unembed
    stacked = stack_layers(pt)
    port_tiles = [n for n in _tiles(stacked)]
    for (i, want), got in zip(tiles, port_tiles):
        new = got.w.detach().numpy()
        diff = np.abs(new - np.asarray(want.w))
        assert np.sum(new != np.asarray(j0[i].w)) > 0, i
        assert (diff > WEIGHT_ATOL).mean() <= MAX_MOVED_SHARE, i
        assert diff.max() <= DW_BOUND, i


def _tiles(tree):
    """The tiles of a stacked tree in the JAX package's leaf order."""
    if isinstance(tree, AnalogState):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tiles(tree[k])


def test_jax_lm_checkpoint_restores_into_the_port_and_back(tmp_path):
    jcfg, pj = jax_state(TWO_PHASE)
    jo = jlm.default_optimizer(jcfg)
    sj = jo.init(pj)
    # a state that is not all zeros: one AdamW step on the digital leaves
    pj, sj = jax.jit(jo.update)(random_grads(pj, 4), sj, pj)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jdir, 3, (pj, sj), {"arch": "deepseek_7b"})

    tcfg = port_cfg(TWO_PHASE)
    to = tlm.default_optimizer(tcfg)
    pt0 = from_jax_params(numpy_tree(jregistry_init(
        jax.random.key(9), jax_cfg(TWO_PHASE))[0]), device="cpu")
    like = stack_layers((pt0, to.init(pt0)))
    restored, meta = tstore.restore(jdir, 3, like)
    assert meta == {"arch": "deepseek_7b"}
    pt, st = unstack_layers(restored, tcfg.n_layers)
    want_p = from_jax_params(numpy_tree(pj), device="cpu")
    want_s = from_jax_opt_state(numpy_tree(sj), device="cpu")
    for a, b in zip(tstore._flatten_with_paths((pt, st)),
                    tstore._flatten_with_paths((want_p, want_s))):
        assert a[0] == b[0]
        if isinstance(a[1], torch.Tensor):
            assert a[1].dtype == b[1].dtype and torch.equal(a[1], b[1]), a[0]
        else:
            assert a[1] == b[1], a[0]
    assert isinstance(pt["layers"], list) and len(pt["layers"]) == 2

    tstore.save(tdir, 3, stack_layers((pt, st)), {"arch": "deepseek_7b"})
    back, _ = jstore.restore(tdir, 3, (pj, sj))
    assert_trees_close_jax(back, (pj, sj))


def assert_trees_close_jax(a, b):
    la, lb = flat(a), flat(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_flash_training_raises_in_both_packages():
    jcfg, pj = jax_state(None, param_dtype=jnp.float32)
    toks = jnp.asarray(tokens())
    with pytest.raises(Exception):
        jax.grad(lambda p: jlm.loss_fn(p, {"tokens": toks}, dataclasses.replace(
            jcfg, use_flash_kernel=True))[0])(pj)
    tcfg = port_cfg(None, param_dtype=torch.float32, use_flash_kernel=True)
    pt = from_jax_params(numpy_tree(pj), device="cpu")
    for t, _ in topt.leaves(pt):
        t.requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        tlm.loss_fn(pt, {"tokens": torch.from_numpy(tokens())}, tcfg)


REFUSALS = [
    dict(fuse_bwd_update=True),
    dict(tile_mesh="2,2"),
    dict(update_chunk=4),
    dict(analog=True, tile_mesh="2x2"),
]


@pytest.mark.parametrize("kw", REFUSALS,
                         ids=["fuse", "mesh", "chunk", "mesh_syntax"])
def test_driver_refusals_carry_jax_messages(kw):
    with pytest.raises(ValueError) as je:
        jtrain.train("deepseek_7b", steps=1, batch=2, seq=8, smoke=True,
                     **kw)
    with pytest.raises(ValueError) as te:
        ttrain.train("deepseek_7b", steps=1, batch=2, seq=8, smoke=True,
                     device="cpu", **kw)
    assert str(te.value).split(" (")[0] == str(je.value).split(" (")[0]


def test_driver_defaults_are_jax_cli_defaults():
    args = ttrain.build_parser().parse_args(["--arch", "lstm"])
    assert args.lr == 3e-4
    jsig = inspect.signature(jtrain.train).parameters
    tsig = inspect.signature(ttrain.train).parameters
    for name in ("lr", "ckpt_every", "scan_chunk", "engine", "bm_mode",
                 "max_restarts", "seed", "log_every"):
        assert tsig[name].default == jsig[name].default, name
    assert (args.scan_chunk, args.ckpt_every, args.steps, args.batch,
            args.seq) == (10, 50, 100, 8, 128)


def test_config_counts_and_legacy_policy_match_jax():
    for smoke in (False, True):
        j = jregistry.get_config("deepseek_7b", smoke=smoke)
        t = tregistry.get_config("deepseek_7b", smoke=smoke)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)
    from repro.core.device import rpu_nm_bm_um_bl1 as jdev
    from repro_torch.core.device import rpu_nm_bm_um_bl1 as tdev
    jp = dataclasses.replace(j, analog=jdev()).resolved_analog_policy()
    tp = dataclasses.replace(t, analog=tdev()).resolved_analog_policy()
    assert [(r.pattern, r.label) for r in tp.rules] == [
        (r.pattern, r.label) for r in jp.rules]
    assert dataclasses.replace(t, analog=tdev()).uses_analog
    with pytest.raises(NotImplementedError, match="Queue 1"):
        from repro_torch.models import transformer
        transformer.forward(
            transformer.init_lm(0, t, device="cpu"),
            torch.zeros(1, 4, dtype=torch.int64),
            dataclasses.replace(t, remat_policy="dots"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_weights_are_jax_init(dtype):
    """``init_lm(jax_weights=True)`` draws the JAX package's initial
    weights (the convergence benchmark starts from them): leaf for leaf in
    the JAX stacked layout, float32 within 3 ulp (``prng.
    truncated_normal``), bfloat16 bitwise."""
    from repro.models import transformer as jT
    from repro_torch.models import transformer as tT
    jc = jax_cfg(None, param_dtype=getattr(jnp, dtype))
    tc = port_cfg(None, param_dtype=getattr(torch, dtype))
    got = flat(stack_layers(tT.init_lm(3, tc, device="cpu",
                                       jax_weights=True)), True)
    want = flat(jT.init_lm(jax.random.key(3), jc)[0])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, k
        ulp = np.abs(a.view(np.int16 if a.itemsize == 2 else np.int32)
                     .astype(np.int64)
                     - b.view(np.int16 if b.itemsize == 2 else np.int32)
                     .astype(np.int64))
        assert ulp.max() <= (0 if dtype == "bfloat16" else 3), k


def test_device_normals_are_jax_normals_within_3_ulp():
    """The seeded device maps' draw on a card (``prng.normal_on_device``,
    run here on the CPU): threefry bits bitwise, normals within 3 ulp of
    ``jax.random.normal`` (as the host draw is)."""
    k, shape = prng.key(123), (4097, 33)
    bits = prng._threefry_bits_t(k, torch.arange(4097 * 33))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32),
                                  prng.random_bits(k, shape).ravel())
    want = np.asarray(jax.random.normal(jax.random.key(123), shape,
                                        dtype=jnp.float32))
    for got in (prng.normal_on_device(k, shape, device="cpu").numpy(),
                prng.normal(k, shape).numpy()):
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert got.dtype == np.float32 and ulp.max() <= 3


def _write_bands(jobs: int = 3):
    """The JAX package's ``analog_lm_convergence`` runs at seeds 0-2 (one
    process each) -> ``jax_lm_bands.json``."""
    import json
    import subprocess
    import sys
    from repro_torch.benchmarks import analog_lm_convergence as conv
    from repro_torch.benchmarks import bands
    procs = {}
    for seed in conv.SEEDS:
        code = ("import json, sys; from repro.launch.train import train; "
                f"kw = json.loads({json.dumps(json.dumps(conv.PROTOCOL))}); "
                f"out = {{m: train('deepseek_7b', seed={seed}, "
                "analog=(m == 'analog'), log_every=1000, **kw)['losses'] "
                "for m in ('digital', 'analog')}; "
                "print('LOSSES' + json.dumps(out))")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH="src" + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs[seed] = subprocess.Popen([sys.executable, "-c", code], env=env,
                                       stdout=subprocess.PIPE, text=True)
    runs = {}
    for seed, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"seed {seed} failed ({p.returncode})")
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][0]
        runs[seed] = json.loads(line[len("LOSSES"):])
    doc = conv.bands_document(runs, versions={
        "jax": jax.__version__, "numpy": np.__version__},
        made_by="python tests/test_torch_lm_train.py --write-bands")
    with open(bands.LM_PATH, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {bands.LM_PATH}")


if __name__ == "__main__":
    import sys
    if "--write-bands" in sys.argv:
        _write_bands()
