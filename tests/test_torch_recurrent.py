"""The port's analog recurrent cells (``repro_torch.recurrent``) against the
JAX package's ``repro.recurrent`` and against their own unrolled oracle.

Small sizes (hidden 8, T 4, B 3, 5 inputs), inputs drawn with numpy from a
seed.  The JAX package runs its reference route (no Pallas); the port runs
the plain versions of its kernels on the CPU, on the separate route
(``use_pallas``: the pulse-count kernel's plain version) or the fused one
(``fuse_bwd_update``: the fused kernel's plain version).  JAX's own fused
recurrent cases do not trace on jax 0.9 (``pl.store``), so the port's fused
route is held against JAX's separate cycles.

Tolerances:

* activations and input cotangents (``hs``, ``dxs``) within ``ACT_ATOL``
  of JAX's: float32 reassociation through T timesteps of reads and gate
  nonlinearities (XLA compiles a scan body differently from a per-op
  torch loop; GRU with two-phase BM drifts by an ulp inside JAX itself);
* weight cotangents ``w_bar`` by ``test_torch_lenet.py``'s rule: at most
  ``MAX_MOVED_SHARE`` of a tile's entries differ from JAX's by more than
  ``WEIGHT_ATOL``, each by at most one coincidence's ``dw`` (``DW_BOUND``);
  an activation an ulp off can flip a Bernoulli draw at ``u ~ p``;
* bitwise: the coincidence counts of ``tile_cycles`` from the same drivers
  and errors (integers), ``copy_task``, the refusal messages, and the
  port's cell against its own ``unrolled_reference`` at every
  ``time_chunk``, for LSTM and GRU, on both routes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog.convert import convert_to_analog as jconvert
from repro.analog.policy import AnalogPolicy as JPolicy
from repro.analog.policy import AnalogRule as JRule
from repro.core import device as jdev
from repro.core import management as jmgmt
from repro.core import update as jupdate
from repro.core.tile import TileState
from repro.data import sequences as jseq
from repro.optim import optimizers as jopt
from repro.recurrent import cell as JC
from repro.recurrent import model as JM
from repro.recurrent import temporal as JT
from repro_torch.analog.convert import convert_to_analog, from_jax_params
from repro_torch.analog.modules import AnalogState
from repro_torch.analog.policy import AnalogPolicy, AnalogRule
from repro_torch.core import device as tdev
from repro_torch.core import update as tupdate
from repro_torch.data import sequences as tseq
from repro_torch.optim import optimizers as topt
from repro_torch.recurrent import cell as C
from repro_torch.recurrent import model as M
from repro_torch.recurrent import oracle as O
from repro_torch.recurrent import temporal as TT
from repro_torch.utils import prng

ACT_ATOL = 1e-5
WEIGHT_ATOL = 1e-6
MAX_MOVED_SHARE = 1e-3
DW_BOUND = 3e-3

D_IN, HID, T_LEN, B = 5, 8, 4, 3
LR = 0.05
TWO = dataclasses.replace(tdev.rpu_nm_bm(), bm_mode="two_phase")
# the port's routes: name -> config (the JAX side runs ``jax_cfg``)
ROUTES = {
    "separate": TWO,
    "kernels": dataclasses.replace(TWO, use_pallas=True),
    "fused": dataclasses.replace(TWO, use_pallas=True, fuse_bwd_update=True),
    "iterative": dataclasses.replace(tdev.rpu_nm_bm(), use_pallas=True),
    "fused_dpw3": dataclasses.replace(TWO, use_pallas=True,
                                      fuse_bwd_update=True,
                                      devices_per_weight=3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker (the plain kernels are
    small; a full thread pool per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(cfg):
    """The JAX package's reference route under the port config's device
    settings (no Pallas, no fusion)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    kw.update(use_pallas=False, fuse_bwd_update=False)
    return jdev.RPUConfig(**kw)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _numpy_tree(tree):
    """A JAX param tree as ``from_jax_params`` takes it."""
    from repro.analog.modules import AnalogState as JState
    if isinstance(tree, JState):
        node = {"w": np.asarray(tree.w),
                "seed": np.asarray(jax.random.key_data(tree.seed)),
                "meta": tree.meta}
        if tree.maps is not None:
            node["maps"] = {f: np.asarray(getattr(tree.maps, f))
                            for f in ("dw_up", "dw_dn", "bound")}
        return node
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cell_pair(kind, tc, cfg):
    """The JAX cell's tiles and the port's made from them."""
    jspec = JC.CellSpec(kind=kind, hidden=HID, time_chunk=tc)
    jp, ja = JC.init_cell(jax.random.key(1), D_IN, jspec)
    jap, _ = jconvert(jp, ja, JPolicy(rules=(JRule("*", jax_cfg(cfg), "t"),
                                             )), key=jax.random.key(2))
    tap = from_jax_params(_numpy_tree(jap), device="cpu")
    for name in ("wx", "wh"):
        tap[name].meta = dataclasses.replace(tap[name].meta, cfg=cfg)
    return jspec, jap, tap


def _inputs():
    return (_rand(3, T_LEN, B, D_IN), _rand(4, T_LEN, B, HID),
            _rand(5, B, HID), _rand(6, B, HID))


def _jax_cell(jspec, jap, cfg, xs, cts):
    def f(wx, wh, xs_):
        return JC._analog_scan(jspec, jax_cfg(cfg), wx, jap["wx"].seed, wh,
                               jap["wh"].seed, xs_, jnp.zeros((B, HID)),
                               jnp.zeros((B, HID)), jax.random.key(7),
                               jnp.float32(LR))
    (hs, _, _), vjp = jax.vjp(f, jap["wx"].w, jap["wh"].w, jnp.asarray(xs))
    wx_bar, wh_bar, dxs = vjp(tuple(jnp.asarray(c) for c in cts))
    return {k: np.asarray(v) for k, v in dict(
        hs=hs, wx_bar=wx_bar, wh_bar=wh_bar, dxs=dxs).items()}


def _port_cell(tap, spec, xs, cts):
    wx = tap["wx"].w.requires_grad_()
    wh = tap["wh"].w.requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    hs, h_t, c_t = C.cell_apply(tap, x, spec, key=prng.key(7), lr=LR)
    outs = (hs, h_t, c_t)
    grads = torch.autograd.grad(outs, (wx, wh, x),
                                tuple(torch.from_numpy(c) for c in cts))
    return dict(hs=hs.detach(), h_t=h_t.detach(), c_t=c_t.detach(),
                wx_bar=grads[0], wh_bar=grads[1], dxs=grads[2])


def assert_weights_close(got, want, what):
    """``test_torch_lenet.py``'s rule for updated weights."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    moved = d > WEIGHT_ATOL
    assert moved.sum() <= MAX_MOVED_SHARE * d.size, (
        f"{what}: {moved.sum()} of {d.size} entries moved, max {d.max()}")
    assert d.max() <= DW_BOUND, f"{what}: max |diff| {d.max()}"


# ---------------------------------------------------------------------------
# The cell against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,tc,route", [
    ("lstm", 1, "separate"), ("lstm", 2, "kernels"), ("lstm", 4, "fused"),
    ("lstm", 2, "iterative"), ("gru", 2, "separate"), ("gru", 1, "fused")],
    ids=lambda v: str(v))
def test_cell_matches_jax(kind, tc, route):
    cfg = ROUTES[route]
    jspec, jap, tap = _cell_pair(kind, tc, cfg)
    xs, *cts = _inputs()
    want = _jax_cell(jspec, jap, cfg, xs, cts)
    got = _port_cell(tap, C.CellSpec(kind=kind, hidden=HID, time_chunk=tc),
                     xs, cts)
    for name in ("hs", "dxs"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=ACT_ATOL, err_msg=name)
    for name in ("wx_bar", "wh_bar"):
        assert_weights_close(got[name], want[name], name)
    assert float(got["wx_bar"].abs().max()) > 1e-3     # the tiles moved


@pytest.mark.parametrize("row0", [0, 2 * B], ids=["row0=0", "row0=tB"])
@pytest.mark.parametrize("route", ["separate", "fused"])
def test_tile_cycles_counts_match_jax(row0, route):
    """From the same drivers and errors, the port's ``tile_cycles`` counts
    are JAX's bit for bit (JAX on its separate route), and the read is
    within ACT_ATOL."""
    cfg = ROUTES[route]
    jspec, jap, tap = _cell_pair("lstm", 1, cfg)
    col = _rand(8, B, D_IN + 1)
    delta = 0.3 * _rand(9, B, 4 * HID)
    jc = jax_cfg(cfg)
    lr = jnp.float32(LR)
    c = jnp.asarray(jmgmt.amplification_factors(jc, lr), jnp.float32)
    k_read, k_a, k_b = jax.random.split(jax.random.key(11), 3)
    st = TileState(w=jap["wx"].w, maps=None, seed=jap["wx"].seed)
    jz, jup, jdn = JC.tile_cycles(st, jnp.asarray(col), jnp.asarray(delta),
                                  k_read, k_a, k_b, jnp.uint32(row0), jc,
                                  lr, c, c, False, 1)
    keys = [prng.from_key_data(jax.random.key_data(k))
            for k in (k_read, k_a, k_b)]
    cx, cd = C.constant_gains(cfg, LR, "cpu")
    z, up, dn = C.tile_cycles(tap["wx"].w, torch.from_numpy(col),
                              torch.from_numpy(delta), *keys, row0, cfg, LR,
                              cx, cd, route == "fused", 1)
    assert torch.equal(up, torch.from_numpy(np.asarray(jup)))
    assert torch.equal(dn, torch.from_numpy(np.asarray(jdn)))
    assert float(up.sum()) > 0 and float(dn.sum()) > 0
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0,
                               atol=ACT_ATOL)


def test_fused_counts_equal_separate_counts():
    """The fused route's counts, accumulated over T timesteps, are the
    separate route's bit for bit (the same streams)."""
    _, _, tap = _cell_pair("lstm", 1, ROUTES["fused"])
    w = tap["wx"].w
    cx, cd = C.constant_gains(TWO, LR, "cpu")
    acc = {}
    for route in ("kernels", "fused"):
        out = None
        for t in range(T_LEN):
            _, *out = C.tile_cycles(
                w, torch.from_numpy(_rand(20 + t, B, D_IN + 1)),
                torch.from_numpy(0.3 * _rand(30 + t, B, 4 * HID)),
                prng.key(1), prng.key(2), prng.key(3), t * B, ROUTES[route],
                LR, cx, cd, route == "fused", 1, out)
            out = tuple(out)
        acc[route] = out
    assert all(torch.equal(a, b) for a, b in zip(acc["kernels"],
                                                  acc["fused"]))


# ---------------------------------------------------------------------------
# The cell against its own unrolled oracle: bitwise
# ---------------------------------------------------------------------------

# every time_chunk on the separate and the fused route; iterative BM and
# three devices per weight at two chunks
ORACLE_CASES = [(kind, tc, route) for kind in ("lstm", "gru")
                for route in ("kernels", "fused") for tc in (1, 2, 4, None)]
ORACLE_CASES += [(kind, tc, route) for kind in ("lstm", "gru")
                 for route in ("iterative", "fused_dpw3") for tc in (1, None)]


@pytest.mark.parametrize("kind,tc,route", ORACLE_CASES,
                         ids=lambda v: str(v))
def test_cell_bitwise_unrolled_oracle(kind, tc, route):
    cfg = ROUTES[route]
    spec = C.CellSpec(kind=kind, hidden=HID, time_chunk=tc)
    tap = convert_to_analog(
        C.init_cell(prng.key(1), D_IN, spec),
        AnalogPolicy(rules=(AnalogRule("*", cfg, "t"),)), key=prng.key(2))
    xs, *cts = _inputs()
    got = _port_cell(tap, spec, xs, cts)
    g = [torch.from_numpy(c) for c in cts]
    ref = O.unrolled_reference(
        spec, cfg, tap["wx"].w.detach(), tap["wx"].seed,
        tap["wh"].w.detach(), tap["wh"].seed, torch.from_numpy(xs),
        torch.zeros(B, HID), torch.zeros(B, HID), prng.key(7), LR, *g)
    for name in ("hs", "h_t", "c_t", "dxs", "wx_bar", "wh_bar"):
        assert torch.equal(got[name], ref[name]), name


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_nonlin_bwd_matches_autograd(kind):
    """The hand-written gate backward is torch autograd of the forward."""
    spec = C.CellSpec(kind=kind, hidden=HID)
    g = spec.gates * HID
    ax, bh = (torch.from_numpy(_rand(s, B, g)).requires_grad_()
              for s in (40, 41))
    hp, cp = (torch.from_numpy(_rand(s, B, HID)).requires_grad_()
              for s in (42, 43))
    dh, dc = (torch.from_numpy(_rand(s, B, HID)) for s in (44, 45))
    h2, c2 = C._nonlin_fwd(spec, ax, bh, hp, cp)
    outs, cts = (h2, c2) if kind == "lstm" else (h2,), (dh, dc)
    d_ax, d_bh, d_hp = torch.autograd.grad(outs, (ax, bh, hp),
                                           cts[:len(outs)],
                                           allow_unused=True)
    dx, dhh, dh_loc, _ = C._nonlin_bwd(spec, ax.detach(), bh.detach(),
                                       hp.detach(), cp.detach(), dh,
                                       dc if kind == "lstm"
                                       else torch.zeros_like(dc))
    torch.testing.assert_close(dx, d_ax, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dhh, d_bh, rtol=1e-5, atol=1e-6)
    # LSTM's h_prev reaches the gates only through the W_h read
    torch.testing.assert_close(dh_loc, torch.zeros_like(dh) if d_hp is None
                               else d_hp, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The temporal dense
# ---------------------------------------------------------------------------

def _temporal_pair(cfg):
    jst = jconvert({"w": {"w": jnp.asarray(0.4 * _rand(50, D_IN, 6)),
                          "b": jnp.zeros(6)}}, None,
                   JPolicy(rules=(JRule("*", jax_cfg(cfg), "t"),)),
                   key=jax.random.key(2))[0]["w"]
    tst = from_jax_params({"w": _numpy_tree(jst)}, device="cpu")["w"]
    tst.meta = dataclasses.replace(tst.meta, cfg=cfg)
    return jst, tst


@pytest.mark.parametrize("route", ["kernels", "fused"])
def test_temporal_dense_matches_jax(route):
    cfg = ROUTES[route]
    jst, tst = _temporal_pair(cfg)
    xs, g = _rand(51, T_LEN, B, D_IN), _rand(52, T_LEN, B, 6)

    def f(w, x):
        st = type(jst)(w, jst.maps, jst.seed, dataclasses.replace(
            jst.meta, cfg=jax_cfg(cfg)))
        return JT.temporal_dense_apply(st, x, jax.random.key(9), lr=LR,
                                       time_chunk=2)
    ys, vjp = jax.vjp(f, jst.w, jnp.asarray(xs))
    w_bar, dxs = vjp(jnp.asarray(g))
    w = tst.w.requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    tys = TT.temporal_dense_apply(tst, x, prng.key(9), lr=LR, time_chunk=2)
    tw_bar, tdxs = torch.autograd.grad(tys, (w, x), torch.from_numpy(g))
    np.testing.assert_allclose(tys.detach().numpy(), np.asarray(ys), rtol=0,
                               atol=ACT_ATOL)
    np.testing.assert_allclose(tdxs.numpy(), np.asarray(dxs), rtol=0,
                               atol=ACT_ATOL)
    assert_weights_close(tw_bar, w_bar, "w_bar")
    assert float(tw_bar.abs().max()) > 1e-3


def test_temporal_dense_is_the_single_shot_update():
    """Every ``time_chunk`` gives one ``w_bar``: the single-shot pulse
    update over the stacked pairs, bit for bit."""
    cfg = ROUTES["kernels"]
    _, tst = _temporal_pair(cfg)
    xs, g = _rand(53, T_LEN, B, D_IN), _rand(54, T_LEN, B, 6)
    bars = []
    for tc in (None, 1, 2):
        w = tst.w.requires_grad_()
        ys = TT.temporal_dense_apply(tst, torch.from_numpy(xs), prng.key(9),
                                     lr=LR, time_chunk=tc)
        bars.append(torch.autograd.grad(ys, w, torch.from_numpy(g))[0])
    assert all(torch.equal(bars[0], b) for b in bars[1:])
    xa = torch.cat([torch.from_numpy(xs), torch.ones(T_LEN, B, 1)], -1)
    k_u = prng.split(prng.key(9), 3)[2]
    maps = tdev.sample_device_maps(tst.seed, *tst.w.shape, cfg)
    single = tupdate.pulse_update(tst.w.detach(), maps, xa,
                                  -torch.from_numpy(g), k_u, cfg, LR)
    assert torch.equal(bars[0], tst.w.detach() - single)
    assert TT.temporal_eligible(cfg)
    assert not TT.temporal_eligible(dataclasses.replace(
        cfg, update_management=True))


# ---------------------------------------------------------------------------
# Refusals, data, optimizer, conversion and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["um", "slow_rng", "grid", "chunk"])
def test_refusals_carry_jax_messages(bad):
    cfg = TWO
    if bad == "um":
        cfg = dataclasses.replace(cfg, update_management=True)
    elif bad == "slow_rng":
        cfg = dataclasses.replace(cfg, fast_rng=False)
    elif bad == "grid":
        cfg = dataclasses.replace(cfg, tile_grid=(2, 2))
    if bad == "chunk":
        spec, jspec = (m.CellSpec(time_chunk=3) for m in (C, JC))
        with pytest.raises(ValueError) as tx:
            C._chunks(spec, 4)
        with pytest.raises(ValueError) as jx:
            JC._chunks(jspec, 4)
    else:
        with pytest.raises((ValueError, NotImplementedError)) as tx:
            C._check_cfg(cfg)
        with pytest.raises((ValueError, NotImplementedError)) as jx:
            JC._check_cfg(jax_cfg(cfg))
    assert tx.type is jx.type and str(tx.value) == str(jx.value)
    with pytest.raises(ValueError, match="unknown recurrent cell kind"):
        C.CellSpec(kind="rnn")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_copy_task_bitwise(seed):
    for kw in (dict(), dict(seq_len=16, delay=2, vocab=8),
               dict(seq_len=3, delay=4, vocab=5)):
        t_tok, t_tgt = tseq.copy_task(10, seed=seed, **kw)
        j_tok, j_tgt = jseq.copy_task(10, seed=seed, **kw)
        np.testing.assert_array_equal(t_tok, j_tok)
        np.testing.assert_array_equal(t_tgt, j_tgt)
        np.testing.assert_array_equal(
            tseq.one_hot_time_major(t_tok, kw.get("vocab", 8)),
            jseq.one_hot_time_major(j_tok, kw.get("vocab", 8)))
        np.testing.assert_array_equal(
            M.one_hot(torch.from_numpy(t_tok), kw.get("vocab", 8)).numpy(),
            tseq.one_hot_time_major(t_tok, kw.get("vocab", 8)))
    with pytest.raises(ValueError, match="vocab >= 3"):
        tseq.copy_task(2, vocab=2)
    with pytest.raises(ValueError, match="delay must be >= 1"):
        tseq.copy_task(2, delay=0)


def test_mixed_analog_matches_jax():
    """Analog leaves take ``p - g``, digital leaves the wrapped SGD."""
    cfg = TWO
    jspec = JC.CellSpec(hidden=HID)
    jp, ja = JC.init_cell(jax.random.key(1), D_IN, jspec)
    jtree = {"cell": jp, "readout": {"w": jnp.asarray(_rand(60, HID, 4)),
                                     "b": jnp.zeros(4)}}
    jaxes = {"cell": ja, "readout": {"w": ("embed", "vocab"),
                                     "b": ("vocab",)}}
    jtree, _ = jconvert(jtree, jaxes, JPolicy(rules=(
        JRule("cell/*", jax_cfg(cfg), "t"),)), key=jax.random.key(2))
    ttree = from_jax_params(_numpy_tree(jtree), device="cpu")
    pairs = topt.leaves(ttree)
    assert [a for _, a in pairs] == [True, True, False, False]
    grads = [torch.from_numpy(_rand(61 + i, *t.shape)) for i, (t, _) in
             enumerate(pairs)]
    # the same gradients on JAX's leaves (zeros on the maps)
    targets = [jtree["cell"]["wx"].w, jtree["cell"]["wh"].w,
               jtree["readout"]["w"], jtree["readout"]["b"]]
    by_id = {id(t): jnp.asarray(g.numpy()) for t, g in zip(targets, grads)}
    jg = jax.tree_util.tree_map(
        lambda x: by_id.get(id(x), jnp.zeros_like(x)
                            if jnp.issubdtype(x.dtype, jnp.floating)
                            else x), jtree)
    opt = jopt.mixed_analog(jopt.sgd(0.1))
    new_j, _ = opt.update(jg, opt.init(jtree), jtree)
    topt.mixed_analog(lambda ps, gs: topt.sgd(ps, gs, lr=0.1))(ttree, grads)
    np.testing.assert_array_equal(ttree["cell"]["wx"].w.numpy(),
                                  np.asarray(new_j["cell"]["wx"].w))
    np.testing.assert_array_equal(ttree["cell"]["wh"].w.numpy(),
                                  np.asarray(new_j["cell"]["wh"].w))
    np.testing.assert_allclose(ttree["readout"]["w"].numpy(),
                               np.asarray(new_j["readout"]["w"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(ttree["readout"]["b"].numpy(),
                               np.asarray(new_j["readout"]["b"]),
                               rtol=0, atol=1e-7)


def _seq_pair(kind, policy_cfg):
    jcfg = JM.SeqConfig(kind=kind, hidden=HID, seq_len=3, lr=LR)
    tcfg = M.SeqConfig(kind=kind, hidden=HID, seq_len=3, lr=LR)
    jp, ja = JM.init(jax.random.key(4), jcfg)
    tp = M.init(prng.key(4), tcfg)
    if policy_cfg is not None:
        jp, _ = jconvert(jp, ja, JPolicy(rules=(JRule(
            "*", jax_cfg(policy_cfg), "t"),)), key=jax.random.key(5))
        tp = convert_to_analog(tp, AnalogPolicy(rules=(AnalogRule(
            "*", policy_cfg, "t"),)), key=prng.key(5))
    return jcfg, tcfg, jp, tp


def test_convert_seq_model_like_jax():
    """``init`` + ``convert_to_analog`` give three tiles with JAX's
    path-keyed seeds, weights (the readout's truncated normal within 4
    ulp) and materialized maps; ``from_jax_params`` carries JAX's tree
    across with the bias flags."""
    _, _, jp, tp = _seq_pair("lstm", TWO)
    jtree = from_jax_params(_numpy_tree(jp), device="cpu")
    for path in (("cell", "wx"), ("cell", "wh"), ("readout",)):
        t, j, jt = tp, jp, jtree
        for k in path:
            t, j, jt = t[k], j[k], jt[k]
        assert isinstance(t, AnalogState) and isinstance(jt, AnalogState)
        assert t.seed == jt.seed == prng.from_key_data(
            jax.random.key_data(j.seed))
        assert t.meta.bias == jt.meta.bias == (path != ("cell", "wh"))
        np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=5e-7,
                                   atol=0)
        np.testing.assert_allclose(t.maps.dw_up.numpy(),
                                   np.asarray(j.maps.dw_up), rtol=1e-6)
        assert torch.equal(jt.w, torch.from_numpy(np.asarray(j.w)))
    assert tuple(tp["cell"]["wx"].w.shape) == (4 * HID, 8 + 1)
    assert tuple(tp["cell"]["wh"].w.shape) == (4 * HID, HID)
    assert tuple(tp["readout"].w.shape) == (8, HID + 1)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_model_loss_and_grads_match_jax(kind):
    """The digital model: loss and every gradient within float tolerance
    of JAX's ``loss_fn`` under ``jax.grad``."""
    jcfg, tcfg, jp, _ = _seq_pair(kind, None)
    tok, tgt = jseq.copy_task(4, seq_len=3, seed=2)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, jnp.asarray(tok),
                                            jnp.asarray(tgt), None, jcfg)
    tp = from_jax_params(_numpy_tree(jp), device="cpu")
    leaves = [t.requires_grad_() for t, _ in topt.leaves(tp)]
    tl = M.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), None,
                   tcfg)
    grads = torch.autograd.grad(tl, leaves)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    jflat = [np.asarray(jg["cell"]["wx"]["w"]), np.asarray(
        jg["cell"]["wx"]["b"]), np.asarray(jg["cell"]["wh"]["w"]),
        np.asarray(jg["readout"]["w"]), np.asarray(jg["readout"]["b"])]
    for g, j in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4, atol=1e-5)


def test_analog_logits_match_jax():
    """The analog model's logits (one noisy read per tile per timestep and
    the readout over all T x B rows) within ACT_ATOL of JAX's."""
    jcfg, tcfg, jp, _ = _seq_pair("lstm", TWO)
    tp = from_jax_params(_numpy_tree(jp), device="cpu")
    tok, _ = jseq.copy_task(4, seq_len=3, seed=2)
    jl = JM.apply(jp, jnp.asarray(tok), jax.random.key(8), jcfg)
    tl = M.apply(tp, torch.from_numpy(tok), prng.key(8), tcfg)
    assert tuple(tl.shape) == (8, 4, 8)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=ACT_ATOL)
