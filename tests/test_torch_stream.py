"""The port's streaming chunks (``conv_stream_chunk``, ``update_chunk``)
against the JAX package on the CPU, and against the port's own
materialized cycles.

The oracle is the JAX package's chunked cycles at the same chunking on its
reference route (``use_pallas=False``), compiled with LLVM's cheap passes
(``CHEAP``, as in test_torch_grid.py) and shared by the cases of one
config.  Tolerances: data movement (im2col chunks, col2im), coincidence
counts and every chunked-against-materialized comparison within the port
are bitwise; reads and the volume cotangent within READ_RTOL of the
largest value of the case (f32 reassociation and ulp-level Box-Muller
differences, test_torch_conv.py's read tolerance); updated weights within
FINALIZE_ATOL (XLA's fused multiply-adds against torch's separate
roundings, test_torch_update.py).  The chunk sizes 7 and 64 do not divide
the 128 positions of the conv fixture (nor 3 the 8 dense rows), so every
case has a short last chunk.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.core import conv_mapping as jcm
from repro.core import device as jdev
from repro.core import tile_grid as jgrid
from repro.core import update as jup
from repro.core.tile import TileState
from repro.models import lenet as jlenet
from repro_torch.analog import presets as tpresets
from repro_torch.core import conv_mapping as tcm
from repro_torch.core import device as tdev
from repro_torch.core import management as tmgmt
from repro_torch.core import update as tup
from repro_torch.data import synthetic_mnist as tdata
from repro_torch.models import lenet as tlenet
from repro_torch.train import cnn as tcnn
from repro_torch.train import engine as tengine
from repro_torch.utils import prng
from test_torch_conv import GEOMS, READ_RTOL
from test_torch_update import FINALIZE_ATOL

LR = 0.01
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread beside the other xdist workers (as in
    test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_run(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=CHEAP)(*args)


def _maps(jcfg, rows, cols, seed):
    jm = jdev.sample_device_maps(jax.random.key(seed), rows, cols, jcfg)
    return jm, tdev.DeviceMaps(*(_t(getattr(jm, f))
                                 for f in ("dw_up", "dw_dn", "bound")))


# ---------------------------------------------------------------------------
# Config: with_streaming, presets, describe_cfg, LeNetConfig
# ---------------------------------------------------------------------------

def test_with_streaming_errors_and_fields_match_jax():
    for kw in (dict(update_chunk=0), dict(conv_stream_chunk=-3)):
        msgs = []
        for cls in (jdev.RPUConfig, tdev.RPUConfig):
            with pytest.raises(ValueError) as e:
                cls().with_streaming(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for cls in (jdev.RPUConfig, tdev.RPUConfig):
        with pytest.raises(ValueError) as e:
            cls(fast_rng=False).with_streaming(update_chunk=4)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a field left None keeps its value
    for cls in (jdev.RPUConfig, tdev.RPUConfig):
        c = cls(bl=3).with_streaming(update_chunk=5).with_streaming(
            conv_stream_chunk=9)
        assert (c.bl, c.update_chunk, c.conv_stream_chunk) == (3, 5, 9)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    if d["tile_grid"] is not None:
        d["tile_grid"] = tuple(d["tile_grid"])
    return d


@pytest.mark.parametrize("spec", [
    "lm_managed:tile_grid=2x2:update_chunk=64",
    "managed:conv_stream_chunk=96:update_chunk=16",
    "nm_bm:bm_mode=two_phase:conv_stream_chunk=384",
    "k2_multi_device:update_chunk=1"])
def test_chunk_presets_resolve_and_describe_as_jax(spec):
    tc, jc = tpresets.resolve_spec(spec), jpresets.resolve_spec(spec)
    assert _fields(tc) == _fields(jc)
    assert tpresets.describe_cfg(tc) == jpresets.describe_cfg(jc)
    assert tpresets.parse_policy(spec).rules[0].cfg == tc


def test_lenet_with_stream_chunks_matches_jax():
    policy = "K2=k2_multi_device,*=managed:bm_mode=two_phase"
    tcfg = tlenet.LeNetConfig.from_policy(
        tpresets.parse_policy(policy)).with_stream_chunks(16, 96)
    jcfg = jlenet.LeNetConfig.from_policy(
        jpresets.parse_policy(policy)).with_stream_chunks(16, 96)
    for layer in tlenet.LAYERS:
        assert _fields(tcfg.cfg(layer)) == _fields(jcfg.cfg(layer))
        assert tcfg.label(layer) == jcfg.label(layer)
    plain = tlenet.LeNetConfig().with_stream_chunks(conv_stream_chunk=7)
    assert all(plain.cfg(n).conv_stream_chunk == 7 and
               plain.cfg(n).update_chunk is None for n in tlenet.LAYERS)


# ---------------------------------------------------------------------------
# Data movement: one chunk of columns, one chunk of col2im
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["strided", "dilated"])
def test_gather_and_col2im_chunks_match_jax(name):
    """Every chunk of 7 and 64 positions (neither divides the positions)
    and the whole volume in one chunk: the columns bitwise JAX's (whose
    rows past the end are zero), the chunk-by-chunk col2im bitwise JAX's
    and the port's whole-volume col2im."""
    b, h, w, c, k, _, s, p, d = GEOMS[name]
    args = ((b, h, w, c), k, s, p, d, True)
    jg, tg = jcm.conv_geometry(*args), tcm.conv_geometry(*args)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    z = rng.normal(size=(tg.positions, tg.features)).astype(np.float32)
    jxp = jcm._pad_volume(jnp.asarray(x), jg)
    txp = tcm._pad_volume(_t(x), tg)
    zeros = np.zeros((tg.b, tg.h, tg.w, tg.c), np.float32)
    whole = tcm.col2im_add(_t(z), tg, 0, tg.positions, _t(zeros))
    for chunk in (7, 64, tg.positions):
        gather = jax.jit(lambda xp_, s_: jcm.gather_columns(xp_, jg, s_,
                                                            chunk))
        col2im = jax.jit(lambda z_, s_, b_: jcm.col2im_add(z_, jg, s_,
                                                           chunk, b_))
        jbar, tbar = jnp.asarray(zeros), _t(zeros)
        for start, n in tup.chunk_starts(tg.positions, chunk):
            jcol = np.asarray(gather(jxp, start))
            tcol = tcm.gather_columns(txp, tg, start, n).numpy()
            np.testing.assert_array_equal(tcol, jcol[:n])
            assert not jcol[n:].any()
            zc = np.zeros((chunk, tg.features), np.float32)
            zc[:n] = z[start:start + n]
            jbar = col2im(jnp.asarray(zc), start, jbar)
            tcm.col2im_add(_t(z[start:start + n]), tg, start, n, tbar)
        np.testing.assert_array_equal(tbar.numpy(), np.asarray(jbar))
        assert torch.equal(tbar, whole)
    with pytest.raises(ValueError):
        tcm.gather_columns(txp, tg, tg.positions - 3, 4)


# ---------------------------------------------------------------------------
# The conv layer's three cycles, chunked
# ---------------------------------------------------------------------------

# name -> RPUConfig fields: NM, two-phase BM, UM and 2 devices per weight
# together; no management; a 2x2 grid; the paper's iterative BM, noise-free
# and noisy (its retries chunk-local on both sides)
CONV_CFGS = {
    "managed_d2": dict(noise_management=True, bound_management=True,
                       bm_mode="two_phase", update_management=True, bl=1,
                       devices_per_weight=2, out_bound=1.0),
    "baseline": dict(),
    "grid_2p": dict(noise_management=True, bound_management=True,
                    bm_mode="two_phase", tile_grid=(2, 2), out_bound=0.5),
    "iterative_noise_free": dict(noise_management=True,
                                 bound_management=True, read_noise=0.0,
                                 out_bound=1.0),
    "iterative": dict(noise_management=True, bound_management=True,
                      out_bound=1.0),
}
CONV_CASES = [("managed_d2", 7), ("managed_d2", 64), ("baseline", 64),
              ("grid_2p", 7), ("iterative_noise_free", 7), ("iterative", 7)]
# (B, H, W, C) -> (B, 8, 8, 5): 128 positions, 28 columns (bias included)
CONV_X, CONV_OUT, CONV_KW = (2, 10, 10, 3), 5, dict(kernel=3)


def _conv_fixture(cfg_kw):
    rng = np.random.default_rng(21)
    d = cfg_kw.get("devices_per_weight", 1)
    x = rng.normal(size=CONV_X).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, (CONV_OUT * d, 28)).astype(np.float32)
    ct = rng.normal(size=(2, 8, 8, CONV_OUT)).astype(np.float32)
    return x, w, ct


def _port_cycles(cfg, w, maps, x, ct):
    """``(y, w_bar, x_bar)`` of the port's conv layer under key 11."""
    wt, xt = _t(w).requires_grad_(), _t(x).requires_grad_()
    y = tcm.apply(wt, xt, prng.key(11), cfg, LR, maps=maps, **CONV_KW)
    w_bar, x_bar = torch.autograd.grad(torch.sum(y * _t(ct)), (wt, xt))
    return y.detach(), w_bar, x_bar


@pytest.mark.parametrize("name,chunk", CONV_CASES, ids=str)
def test_chunked_conv_cycles_match_jax(name, chunk):
    """Forward, backward and update of one conv layer at ``chunk``: the
    port against JAX's chunked cycles; the port's chunked cycles against
    its materialized ones bitwise (except under iterative BM with read
    noise, whose retries are chunk-local)."""
    kw = CONV_CFGS[name]
    tcfg = tdev.RPUConfig(**kw).with_streaming(conv_stream_chunk=chunk)
    jcfg = jdev.RPUConfig(**kw).with_streaming(conv_stream_chunk=chunk)
    x, w, ct = _conv_fixture(kw)
    jm, maps = _maps(jcfg, *w.shape, seed=5)

    def jax_cycles(w_, x_, ct_):
        def f(ww, xx):
            st = TileState(w=ww, maps=jm, seed=jax.random.key(0))
            return jcm.apply(st, xx, jax.random.key(11), jcfg, LR,
                             **CONV_KW)
        y, vjp = jax.vjp(f, w_, x_)
        return (y,) + vjp(ct_)

    jy, jw_bar, jx_bar = (np.asarray(a) for a in _jax_run(
        jax_cycles, w, x, ct))
    y, w_bar, x_bar = _port_cycles(tcfg, w, maps, x, ct)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=READ_RTOL * np.abs(jy).max())
    np.testing.assert_allclose(x_bar.numpy(), jx_bar, rtol=0,
                               atol=READ_RTOL * np.abs(jx_bar).max())
    np.testing.assert_allclose(w_bar.numpy(), jw_bar, rtol=0,
                               atol=FINALIZE_ATOL)
    assert np.abs(jw_bar).max() > 0
    if name != "iterative":
        whole = _port_cycles(dataclasses.replace(tcfg, conv_stream_chunk=None),
                             w, maps, x, ct)
        for got, want in zip((y, w_bar, x_bar), whole):
            assert torch.equal(got, want)


def test_conv_fixtures_saturate_and_retry():
    """Every bounded fixture reads past alpha (two-phase BM selects its
    second read, a grid's first column block saturates, iterative BM
    retries), so the BM paths above are exercised."""
    geom = tcm.conv_geometry(CONV_X, 3)
    for name in ("managed_d2", "grid_2p", "iterative"):
        kw = CONV_CFGS[name]
        x, w, ct = _conv_fixture(kw)
        cols = tcm.gather_columns(_t(x), geom, 0, geom.positions)
        y = (cols / tmgmt.nm_scale(cols))[:, :14] @ _t(w)[:, :14].T
        assert float(y.abs().max()) > kw["out_bound"], name
    cfg = tdev.RPUConfig(**CONV_CFGS["iterative"]).with_streaming(
        conv_stream_chunk=7)
    maps = tdev.sample_device_maps(prng.key(5), *w.shape, cfg)
    with tmgmt.count_retries("cpu") as n:
        _port_cycles(cfg, w, maps, x, ct)
    assert int(n) > 0


# ---------------------------------------------------------------------------
# Dense and grid updates, chunked
# ---------------------------------------------------------------------------

DENSE_CASES = [("dense", None), ("dense_um", None), ("grid", (2, 2)),
               ("grid_um", (2, 2))]


@pytest.mark.parametrize("name,grid", DENSE_CASES, ids=str)
def test_chunked_update_matches_jax(name, grid):
    """``update_chunk=3`` over 8 vector pairs (chunks of 3, 3, 2) on a
    plain tile and a 2x2 grid with 2 devices per weight: the port against
    JAX's chunked update, and bitwise its own unchunked update; the plain
    tile's counts bitwise JAX's ``_chunked_counts``."""
    um = name.endswith("um")
    kw = dict(bl=1 if um else 10, update_management=um, tile_grid=grid,
              devices_per_weight=2)
    tcfg = tdev.RPUConfig(**kw).with_streaming(update_chunk=3)
    jcfg = jdev.RPUConfig(**kw).with_streaming(update_chunk=3)
    rng = np.random.default_rng(8)
    m, n = 7, 13
    x = rng.normal(size=(8, n)).astype(np.float32)
    delta = (0.3 * rng.normal(size=(8, m))).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (2 * m, n)).astype(np.float32)
    jm, maps = _maps(jcfg, 2 * m, n, 6)
    jw = _jax_run(lambda w_, x_, d_: jup.pulse_update(
        w_, jm, x_, d_, jax.random.key(4), jcfg, LR), w, x, delta)
    tw = tup.pulse_update(_t(w), maps, _t(x), _t(delta), prng.key(4), tcfg,
                          LR)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)
    assert not np.array_equal(tw.numpy(), w)
    whole = tup.pulse_update(_t(w), maps, _t(x), _t(delta), prng.key(4),
                             dataclasses.replace(tcfg, update_chunk=None), LR)
    assert torch.equal(tw, whole)
    if grid is None:
        d2 = np.concatenate([delta, delta], axis=1)
        ka, kb = prng.split(prng.key(4), 3)[:2]
        cx, cd = tmgmt.um_factors(_t(x), _t(d2), tcfg, LR)
        up, dn = tup._chunked_counts(_t(x), _t(d2), cx, cd, ka, kb, tcfg, 3)
        jka, jkb = jax.random.split(jax.random.key(4), 3)[:2]
        jcx, jcd = jup.um_factors(jnp.asarray(x), jnp.asarray(d2), jcfg, LR)
        jup_, jdn = jup._chunked_counts(jnp.asarray(x), jnp.asarray(d2), jcx,
                                        jcd, jka, jkb, jcfg, 3, 2 * m, n)
        np.testing.assert_array_equal(up.numpy(), np.asarray(jup_))
        np.testing.assert_array_equal(dn.numpy(), np.asarray(jdn))
        assert float(up.sum()) > 0 and float(dn.sum()) > 0


def test_grid_streamed_chunks_match_jax():
    """The grid's conv entry over generated chunks of 9 rows (40 rows:
    chunks of 9, 9, 9, 9, 4) against JAX's serial streamed grid update, and
    bitwise the port's one-chunk update."""
    tcfg, jcfg = (c(tile_grid=(2, 2), update_management=True, bl=1)
                  for c in (tdev.RPUConfig, jdev.RPUConfig))
    rng = np.random.default_rng(12)
    p, m, n = 40, 6, 13
    cols = rng.normal(size=(p, n)).astype(np.float32)
    dphys = (0.3 * rng.normal(size=(p, m))).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (m, n)).astype(np.float32)
    jm, maps = _maps(jcfg, m, n, 7)
    maxima = (np.abs(cols).max(), np.abs(dphys).max())

    def get_chunk(s, start, ch):
        return (jax.lax.dynamic_slice_in_dim(s[0], start, ch),
                jax.lax.dynamic_slice_in_dim(s[1], start, ch))

    cp = np.concatenate([cols, np.zeros((5, n), np.float32)])
    dp = np.concatenate([dphys, np.zeros((5, m), np.float32)])
    jw = _jax_run(lambda w_, c_, d_: jgrid.grid_pulse_update_streamed(
        w_, jm, (c_, d_), get_chunk, jax.random.key(3), jcfg, LR, total=p,
        chunk=9, um_maxima=tuple(jnp.float32(v) for v in maxima),
        force_reference=True), w, cp, dp)

    def run(chunk):
        return tup.pulse_update_streamed(
            _t(w), maps, (_t(cols), _t(dphys)),
            lambda s, start, k: (s[0][start:start + k], s[1][start:start + k]),
            prng.key(3), tcfg, LR, total=p, chunk=chunk,
            um_maxima=tuple(torch.tensor(v) for v in maxima))

    tw = run(9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)
    assert torch.equal(tw, run(p))


# ---------------------------------------------------------------------------
# One LeNet step, chunked, under both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [
    "managed:use_pallas=true:bm_mode=two_phase",
    "managed:use_pallas=true:bm_mode=two_phase:tile_grid=2x2",
    "nm_bm:use_pallas=true:out_bound=1:read_noise=0"])
def test_lenet_chunked_step_is_the_materialized_step(policy):
    """One step of the full-width LeNet at batch 2 with chunks of 100
    positions (K1's 1152 in 12, the last short; K2's 128 in 2) and update
    chunks of 1: the epoch engine (uncaptured on the CPU) and the loop
    leave every tile bitwise equal to the materialized loop's."""
    base = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(policy))
    cfg = base.with_stream_chunks(update_chunk=1, conv_stream_chunk=100)
    x, y = tdata.make_dataset(2, seed=1)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    k_data, k_train = prng.key(3), prng.key(2)
    out = []
    for c, engine in ((base, "python"), (cfg, "python"), (cfg, "scan")):
        p = tlenet.init(prng.key(0), c)
        if engine == "scan":
            tengine.make_cnn_epoch_fn(c, batch=2)(p, xs, ys, k_data,
                                                  k_train, 0)
        else:
            tcnn.python_epoch(tcnn.make_train_step(c), p, xs, ys, k_data,
                              k_train, 0, 2)
        out.append(p)
    for name in tlenet.LAYERS:
        assert not torch.equal(out[0][name].w,
                               tlenet.init(prng.key(0), base)[name].w)
        for other in out[1:]:
            assert torch.equal(other[name].w, out[0][name].w), name
