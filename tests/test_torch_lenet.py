"""The port's LeNet training path against the JAX package at the paper's
full widths (K1 16x26, K2 32x401 or 416x401, W3 128x513, W4 10x129).

The whole-step test carries the JAX package's initial parameters (weights,
device maps, seeds) across with ``from_jax_params`` and runs one training
step in both packages on the same images, labels and key: the port under
the FUSED policy (its fused backward+update route, plain versions on the
CPU) and the JAX package on its reference path under the same device
settings, which its own tests pin bitwise to its fused kernels.  Logits
agree within LOGIT_ATOL (f32 reassociation through four layers; XLA's tanh
and its fused multiply-adds differ from torch's by an ulp).  An activation
an ulp off can flip a Bernoulli draw at ``u ~ p``, so the new weights are
held entry by entry: at most MAX_MOVED_SHARE of a tile's entries may differ
by more than WEIGHT_ATOL, and each of those by at most one coincidence's
``dw`` (DW_BOUND: dw_min with its 30% device spread and 30% ctoc noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.data import synthetic_mnist as jdata
from repro.models import lenet as jlenet
from repro.train import cnn as jcnn
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.data import synthetic_mnist as tdata
from repro_torch.kernels import ops as tops
from repro_torch.models import lenet as tlenet
from repro_torch.train import cnn as tcnn
from repro_torch.utils import prng

LOGIT_ATOL = 1e-6
WEIGHT_ATOL = 1e-6
MAX_MOVED_SHARE = 1e-3
DW_BOUND = 3e-3

FUSED = "managed:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
PAPER = ("K2=k2_multi_device:use_pallas=true:bm_mode=two_phase"
         ":fuse_bwd_update=true,*=" + FUSED)
# the JAX package's reference route under the same device settings
JAX_REF = {FUSED: "managed:bm_mode=two_phase",
           PAPER: "K2=k2_multi_device:bm_mode=two_phase,"
                  "*=managed:bm_mode=two_phase"}


def _numpy_tree(params):
    out = {}
    for name, s in params.items():
        node = {"w": np.asarray(s.w),
                "seed": np.asarray(jax.random.key_data(s.seed)),
                "meta": s.meta}
        if s.maps is not None:
            node["maps"] = {f: np.asarray(getattr(s.maps, f))
                            for f in ("dw_up", "dw_dn", "bound")}
        out[name] = node
    return out


def _batch():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (2, 28, 28, 1)).astype(np.float32)
    return x, np.array([3, 7], np.int32)


@pytest.mark.parametrize("policy", [FUSED, PAPER], ids=["fused", "paper"])
def test_train_step_matches_jax(policy):
    jcfg = jlenet.LeNetConfig.from_policy(
        jpresets.parse_policy(JAX_REF[policy]))
    tcfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(policy))
    pj = jlenet.init(jax.random.key(3), jcfg)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    assert tuple(pt["K2"].w.shape) == ((416, 401) if policy == PAPER
                                       else (32, 401))
    x, y = _batch()

    with torch.no_grad():
        lt = tlenet.apply(pt, torch.from_numpy(x), prng.key(5), tcfg)
    lj = jax.jit(lambda p, xx: jlenet.apply(p, xx, jax.random.key(5),
                                            jcfg))(pj, jnp.asarray(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)

    step, opt = jcnn.make_train_step(jcfg)
    pj2, _ = step(pj, opt.init(pj), jnp.asarray(x), jnp.asarray(y),
                  jax.random.key(5))
    tcnn.make_train_step(tcfg)(pt, torch.from_numpy(x), torch.from_numpy(y),
                               prng.key(5))
    for name in tlenet.LAYERS:
        new = pt[name].w.detach().numpy()
        want = np.asarray(pj2[name].w)
        assert np.sum(new != np.asarray(pj[name].w)) > 0, name
        diff = np.abs(new - want)
        far = diff > WEIGHT_ATOL
        assert far.mean() <= MAX_MOVED_SHARE, name
        assert diff.max() <= DW_BOUND, name


def test_train_on_cpu_learns_structure():
    """``train`` on the CPU: the history, the steps and moved weights."""
    cfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(FUSED))
    r = tcnn.train(cfg, epochs=2, batch=8, n_train=16, n_test=20,
                   device="cpu", verbose=False, return_params=True)
    assert len(r["test_error"]) == 2
    assert all(0.0 <= e <= 1.0 for e in r["test_error"])
    assert r["device"] == "cpu" and r["steps_per_sec"] > 0
    init = tlenet.init(prng.split(prng.key(0), 4)[0], cfg)
    for name in tlenet.LAYERS:
        assert not torch.equal(r["params"][name].w.detach(), init[name].w)


def test_no_kernel_launch_on_cpu():
    tops.reset_launch_counts()
    cfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(PAPER))
    params = tlenet.init(prng.key(1), cfg)
    x, y = _batch()
    tcnn.make_train_step(cfg)(params, torch.from_numpy(x),
                              torch.from_numpy(y), prng.key(2))
    assert set(tops.launch_counts().values()) == {0}


def test_make_train_step_takes_opt():
    """``opt(ws, grads)`` replaces the default step: it gets one gradient
    per tile, of the tile's shape, and a step that ignores them leaves the
    tiles as they were, where the default moves them."""
    cfg = tlenet.LeNetConfig(mode="digital")
    x, y = (torch.from_numpy(a) for a in _batch())
    calls = []
    for opt in (None, lambda ws, gs: calls.append([g.shape for g in gs])):
        params = tlenet.init(prng.key(1), cfg)
        before = [params[n].w.detach().clone() for n in tlenet.LAYERS]
        tcnn.make_train_step(cfg, opt)(params, x, y, None)
        same = [torch.equal(b, params[n].w.detach())
                for b, n in zip(before, tlenet.LAYERS)]
        assert same == [opt is not None] * 4
    assert calls == [[params[n].w.shape for n in tlenet.LAYERS]]


def test_eval_pads_the_last_batch():
    cfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(FUSED))
    params = tlenet.init(prng.key(1), cfg)
    xs = torch.from_numpy(_batch()[0].repeat(3, axis=0))     # 6 images
    ys = torch.arange(6) % 10
    key = prng.key(4)
    err = tcnn.make_eval(cfg, batch=4)(params, xs, ys, key)
    hits = 0
    with torch.no_grad():
        for start in (0, 4):
            x = xs[start:start + 4]
            x = torch.cat([x, x.new_zeros((4 - len(x),) + x.shape[1:])])
            logits = tlenet.apply(params, x, prng.fold_in(key, start), cfg)
            hits += int((logits.argmax(-1)[:len(ys[start:start + 4])]
                         == ys[start:start + 4]).sum())
    assert err == pytest.approx(1.0 - hits / 6)


def test_synthetic_mnist_matches_jax():
    xt, yt = tdata.make_dataset(12, seed=3)
    xj, yj = jdata.make_dataset(12, seed=3)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


def test_epoch_permutation():
    k = prng.split(prng.key(0), 4)[1]
    p0 = tcnn.epoch_permutation(k, 0, 50)
    assert sorted(p0.tolist()) == list(range(50))
    assert torch.equal(p0, tcnn.epoch_permutation(k, 0, 50))
    assert not torch.equal(p0, tcnn.epoch_permutation(k, 1, 50))


def test_feature_sizes():
    cfg = tlenet.LeNetConfig()
    assert tlenet.feature_sizes(cfg) == jlenet.feature_sizes(
        jlenet.LeNetConfig())
