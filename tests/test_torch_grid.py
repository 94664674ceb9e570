"""The port's crossbar tile grids (``repro_torch.core.tile_grid``) against
the JAX package's serial grid (``repro.core.tile_grid``) on the CPU.

Inputs come from fixed numpy seeds, keys from fixed integers.  Reads agree
within RTOL of the largest sum |x||w| (f32 reassociation and ulp-level
Box-Muller differences, the read tolerance of test_torch_read.py) with
equal saturation flags; counts are integers and agree bitwise; updated
weights agree within FINALIZE_ATOL (test_torch_update.py: XLA's fused
multiply-adds against torch's separate roundings).  The whole LeNet step
is held at test_torch_lenet.py's tolerances, and the epoch engine against
the per-step loop bitwise.  The JAX programs are compiled with LLVM's
cheap passes (``CHEAP``: the same program, a third less compile time) to
keep the file inside its time budget.  The CUDA cases (marked ``cuda``) need the card
and skip here; ``chip_smoke.py`` phases b and g3 hold the grid on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.core import device as jdev
from repro.core import tile as jtile
from repro.core import tile_grid as jgrid
from repro.core import update as jup
from repro.models import lenet as jlenet
from repro.train import cnn as jcnn
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.core import device as tdev
from repro_torch.core import management as tmgmt
from repro_torch.core import tile as ttile
from repro_torch.core import tile_grid as tgrid
from repro_torch.core import update as tup
from repro_torch.data import synthetic_mnist as tdata
from repro_torch.kernels import noisy_mvm as tnoisy
from repro_torch.kernels import ops as tops
from repro_torch.models import lenet as tlenet
from repro_torch.train import cnn as tcnn
from repro_torch.train import engine as tengine
from repro_torch.utils import prng
from test_torch_lenet import (DW_BOUND, LOGIT_ATOL, MAX_MOVED_SHARE,
                              WEIGHT_ATOL, _batch, _numpy_tree)
from test_torch_update import FINALIZE_ATOL

RTOL = 1e-5
LR = 0.01
GRID_2P = "managed:use_pallas=true:bm_mode=two_phase:tile_grid=2x2"
# a block integrates part of the contraction: at alpha 1 no block read of
# LeNet's first steps saturates, at alpha 0.5 they retry
GRID_IT = "nm_bm:use_pallas=true:tile_grid=2x2:out_bound=0.5"
# the JAX package's reference route under the same device settings
JAX_REF = {GRID_2P: "managed:bm_mode=two_phase:tile_grid=2x2",
           GRID_IT: "nm_bm:tile_grid=2x2:out_bound=0.5"}
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per module beside the other xdist workers (as in
    test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_run(f, *args):
    """``jax.jit(f)(*args)``, compiled with ``CHEAP``."""
    return jax.jit(f).lower(*args).compile(compiler_options=CHEAP)(*args)


def _cfgs(**kw):
    return tdev.RPUConfig(**kw), jdev.RPUConfig(**kw)


def _operands(rows, cols, b, transpose, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.4, 0.4, (rows, cols)).astype(np.float32)
    x = (scale * rng.uniform(-1, 1, (b, rows if transpose else cols))
         ).astype(np.float32)
    return w, x


def _assert_read_close(yt, st, yj, sj, w, x, transpose):
    mag = float(np.max(np.abs(x) @ (np.abs(w) if transpose
                                    else np.abs(w).T)))
    yj, sj = np.asarray(yj), np.asarray(sj)
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=RTOL * mag)
    np.testing.assert_array_equal(st.numpy(), sj)


# ---------------------------------------------------------------------------
# Geometry and presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,grid", [
    ((16, 26), (2, 2)), ((32, 401), (2, 2)), ((13, 37), (3, 2)),
    ((10, 129), (1, 4)), ((11008, 4096), (3, 1)), ((5, 7), (5, 7))])
def test_geometry_matches_jax(shape, grid):
    tcfg, jcfg = _cfgs(tile_grid=grid)
    tg, jg = tgrid.TileGrid.for_tile(shape, tcfg), jgrid.TileGrid.for_tile(
        shape, jcfg)
    for f in ("grid_rows", "grid_cols", "rows_phys", "cols", "n_blocks",
              "block_rows", "block_cols", "rows_pad", "cols_pad"):
        assert getattr(tg, f) == getattr(jg, f), f


@pytest.mark.parametrize("shape,grid", [((4, 6), (5, 1)), ((4, 6), (1, 7)),
                                        ((4, 6), (0, 2))])
def test_geometry_refuses_what_jax_refuses(shape, grid):
    tcfg = dataclasses.replace(tdev.RPUConfig(), tile_grid=grid)
    jcfg = dataclasses.replace(jdev.RPUConfig(), tile_grid=grid)
    with pytest.raises(ValueError):
        jgrid.TileGrid.for_tile(shape, jcfg)
    with pytest.raises(ValueError):
        tgrid.TileGrid.for_tile(shape, tcfg)


@pytest.mark.parametrize("spec", ["managed:tile_grid=2x2",
                                  "nm_bm:use_pallas=true:tile_grid=3x1",
                                  "k2_multi_device:tile_grid=1x4"])
def test_presets_parse_and_label_as_jax(spec):
    tc = tpresets.resolve_spec(spec)
    jc = jpresets.resolve_spec(spec)
    assert tc.tile_grid == tuple(jc.tile_grid)
    plain = spec.replace(":use_pallas=true", "")   # "cuda" vs "pallas"
    assert tpresets.describe_cfg(tpresets.resolve_spec(plain)) == \
        jpresets.describe_cfg(jpresets.resolve_spec(plain))
    assert tpresets.parse_policy(spec).rules[0].cfg == tc


def test_presets_refuse_chunks_and_bad_grids():
    """Chunks below 1 and empty grids are refused as in JAX; chunks of 1
    and more resolve to JAX's fields, on a grid too."""
    for spec in ("managed:update_chunk=0", "managed:conv_stream_chunk=-1",
                 "managed:tile_grid=2x2:update_chunk=0",
                 "managed:tile_grid=0x2", "managed:tile_grid=2x-1"):
        with pytest.raises(ValueError):
            jpresets.resolve_spec(spec)
        with pytest.raises(ValueError):
            tpresets.resolve_spec(spec)
    for spec in ("managed:update_chunk=16", "managed:conv_stream_chunk=96",
                 "managed:tile_grid=2x2:update_chunk=16"):
        tc, jc = tpresets.resolve_spec(spec), jpresets.resolve_spec(spec)
        assert (tc.update_chunk, tc.conv_stream_chunk, tc.tile_grid) == (
            jc.update_chunk, jc.conv_stream_chunk,
            None if jc.tile_grid is None else tuple(jc.tile_grid))


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------

def test_trivial_grid_is_the_plain_read():
    """(1, 1): the grid read is the plain read bit for bit, and the tile
    cycles do not route through the grid."""
    cfg = tdev.RPUConfig(tile_grid=(1, 1), out_bound=1.0)
    for transpose in (False, True):
        w, x = _operands(13, 37, 5, transpose, seed=1, scale=0.7)
        yg, sg = tgrid.grid_analog_mvm(_t(w), _t(x), prng.key(4), cfg,
                                       transpose=transpose)
        yp, sp = ttile.analog_mvm_reference(_t(w), _t(x), prng.key(4), cfg,
                                            transpose=transpose)
        assert torch.equal(yg, yp) and torch.equal(sg, sp)
        assert sp.any() and not sp.all()
    assert not ttile._grid_routed(cfg)
    assert ttile._grid_routed(dataclasses.replace(cfg, tile_grid=(1, 2)))


@pytest.mark.parametrize("grid,shape", [((2, 2), (16, 26)),
                                        ((3, 2), (13, 37))])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "bwd"])
def test_raw_grid_read_matches_jax(grid, shape, transpose):
    """Padded grids, noise on, alpha 1 so that blocks saturate: the serial
    grid read of both packages (the port's plain block reads)."""
    tcfg, jcfg = _cfgs(tile_grid=grid, out_bound=1.0)
    w, x = _operands(*shape, 6, transpose, seed=sum(shape), scale=2.0)
    x = x * np.float32([0.1, 1.0])[np.arange(6) % 2][:, None]
    yt, st = tgrid.grid_analog_mvm(_t(w), _t(x), prng.key(7), tcfg,
                                   transpose=transpose)
    yj, sj = _jax_run(lambda a, b: jgrid.grid_analog_mvm_reference(
        a, b, jax.random.key(7), jcfg, transpose=transpose), w, x)
    _assert_read_close(yt, st, yj, sj, w, x, transpose)
    assert st.any() and not st.all()


def test_grid_read_splits_segments_within_a_block():
    """A block whose contraction exceeds the array limit reads in segments
    of its own (block 40 columns over 16-column arrays: 3 segments)."""
    tcfg, jcfg = _cfgs(tile_grid=(2, 2), max_array_cols=16)
    w, x = _operands(10, 80, 3, False, seed=5)
    yt, st = tgrid.grid_analog_mvm(_t(w), _t(x), prng.key(2), tcfg)
    yj, sj = _jax_run(lambda a, b: jgrid.grid_analog_mvm_reference(
        a, b, jax.random.key(2), jcfg), w, x)
    _assert_read_close(yt, st, yj, sj, w, x, False)


MANAGED = {
    "two_phase": dict(noise_management=True, nm_forward=True,
                      bound_management=True, bm_mode="two_phase",
                      out_bound=1.0),
    "iterative": dict(noise_management=False, bound_management=True,
                      bm_mode="iterative", out_bound=1.0),
    "iterative_nm": dict(noise_management=True, nm_forward=True,
                         bound_management=True, bm_mode="iterative",
                         out_bound=0.1, bm_max_iters=3),
}


@pytest.mark.parametrize("mode,transpose", [
    ("two_phase", True), ("iterative", False), ("iterative_nm", True)],
    ids=["two_phase-bwd", "iterative-fwd", "iterative_nm-bwd"])
def test_managed_grid_read_matches_jax(mode, transpose):
    """Managed reads over the grid (the iterative cases retry: alpha 1
    without NM, and alpha 0.1 with NM and 3 retries, which leaves vectors
    saturated) against ``grid_managed_mvm(force_reference=True)``."""
    tcfg, jcfg = _cfgs(tile_grid=(3, 2), **MANAGED[mode])
    w, x = _operands(13, 37, 6, transpose, seed=3, scale=4.0)
    yt, st = tgrid.grid_managed_mvm(_t(w), _t(x), prng.key(9), tcfg,
                                    transpose=transpose, backward=transpose)
    yj, sj = _jax_run(lambda a, b: jgrid.grid_managed_mvm(
        a, b, jax.random.key(9), jcfg, transpose=transpose,
        backward=transpose, force_reference=True), w, x)
    # a retry reads x / s and scales back by s: within RTOL of the
    # largest |y| (test_torch_management.py)
    yj, sj = np.asarray(yj), np.asarray(sj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=RTOL * float(np.abs(yj).max()))
    np.testing.assert_array_equal(st.numpy(), sj)
    if mode == "iterative_nm":
        assert st.any()
    if mode != "two_phase":
        with tmgmt.count_retries("cpu") as n:
            tgrid.grid_managed_mvm(_t(w), _t(x), prng.key(9), tcfg,
                                   transpose=transpose, backward=transpose)
        assert int(n) > 0


@pytest.mark.parametrize("mode", ["two_phase", "iterative"])
def test_grid_cycles_with_replicas_match_jax(mode):
    """``grid_tile_forward`` (replica average after the grid read) and
    ``grid_tile_backward`` (divided by #_d) with #_d 3, routed from
    ``tile_forward``/``tile_backward``."""
    tcfg, jcfg = _cfgs(tile_grid=(2, 2), devices_per_weight=3,
                       **MANAGED[mode])
    rng = np.random.default_rng(8)
    w = rng.uniform(-0.4, 0.4, (3 * 5, 11)).astype(np.float32)
    x = (2.0 * rng.uniform(-1, 1, (4, 11))).astype(np.float32)
    d = rng.uniform(-1, 1, (4, 5)).astype(np.float32)

    def cycles(w_, x_, d_):
        state = jtile.TileState(w_, None, jax.random.key(0))
        return (jtile.tile_forward(state, x_, jax.random.key(1), jcfg),
                jtile.tile_backward(state, d_, jax.random.key(2), jcfg))

    yj, zj = _jax_run(cycles, w, x, d)
    yt = ttile.tile_forward(_t(w), _t(x), prng.key(1), tcfg)
    zt = ttile.tile_backward(_t(w), _t(d), prng.key(2), tcfg)
    for got, want in ((yt, yj), (zt, zj)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

def _maps(jcfg, rows, cols, seed):
    jm = jdev.sample_device_maps(jax.random.key(seed), rows, cols, jcfg)
    return jm, tdev.DeviceMaps(*(_t(getattr(jm, f))
                                 for f in ("dw_up", "dw_dn", "bound")))


UPDATE_CFGS = {"ctoc0": dict(dw_min_ctoc=0.0, bl=10),
               "ctoc": dict(bl=10),
               "managed": dict(bl=1, update_management=True)}


@pytest.mark.parametrize("name", list(UPDATE_CFGS))
def test_grid_pulse_update_matches_jax(name):
    """The dense grid update (3x2 with padding, #_d 2) against the JAX
    package's serial grid update (block by block)."""
    tcfg, jcfg = _cfgs(tile_grid=(3, 2), devices_per_weight=2,
                       **UPDATE_CFGS[name])
    rng = np.random.default_rng(len(name))
    w = rng.uniform(-0.5, 0.5, (2 * 7, 11)).astype(np.float32)
    x = rng.normal(size=(5, 11)).astype(np.float32)
    delta = (0.3 * rng.normal(size=(5, 7))).astype(np.float32)
    jm, maps = _maps(jcfg, 14, 11, 3)
    jw = _jax_run(lambda w_, l: jup.pulse_update(
        w_, jm, jnp.asarray(x), jnp.asarray(delta), jax.random.key(6), jcfg,
        l), jnp.asarray(w), jnp.float32(LR))
    d_rep = ttile.replicate_delta(_t(delta), 2)
    tw = tgrid.grid_pulse_update(_t(w), maps, _t(x), d_rep, prng.key(6),
                                 tcfg, LR)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)
    assert not np.array_equal(tw.numpy(), w)
    routed = tup.pulse_update(_t(w), maps, _t(x), _t(delta), prng.key(6),
                              tcfg, LR)
    assert torch.equal(routed, tgrid.grid_pulse_update(
        _t(w), maps, _t(x), d_rep, prng.key(6), tcfg, LR))


def test_grid_counts_over_padded_streams_match_jax():
    """The streams drawn over the padded drivers and counted at once give
    JAX's per-block counts bitwise."""
    tcfg, jcfg = _cfgs(tile_grid=(3, 2), bl=10)
    g = tgrid.TileGrid.for_tile((13, 37), tcfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 37)).astype(np.float32)
    d = (0.2 * rng.normal(size=(6, 13))).astype(np.float32)
    jg = jgrid.TileGrid.for_tile((13, 37), jcfg)
    br, bc = g.block_rows, g.block_cols

    def block_counts(x_, d_):
        k_a, k_b, _ = jax.random.split(jax.random.key(4), 3)
        cx, cd = jup.um_factors(x_, d_, jcfg, jnp.float32(LR))
        cols_s = jup.sample_signed_streams(k_a, jg.pad_last(x_, 38), cx, 10)
        rows_s = jup.sample_signed_streams(k_b, jg.pad_last(d_, 15), cd, 10)
        return [[jup.coincidence_counts(rows_s[..., i * br:(i + 1) * br],
                                        cols_s[..., j * bc:(j + 1) * bc])
                 for j in range(2)] for i in range(3)]

    want = _jax_run(block_counts, x, d)
    ta, tb, _ = prng.split(prng.key(4), 3)
    tcx, tcd = tmgmt.um_factors(_t(x), _t(d), tcfg, LR)
    up, dn = tup.stream_counts(g.pad_last(_t(x), g.cols_pad),
                               g.pad_last(_t(d), g.rows_pad), tcx, tcd, ta,
                               tb, tcfg)
    for i in range(3):
        for j in range(2):
            jup_, jdn = want[i][j]
            blk = (slice(i * br, (i + 1) * br), slice(j * bc, (j + 1) * bc))
            np.testing.assert_array_equal(up[blk].numpy(), np.asarray(jup_))
            np.testing.assert_array_equal(dn[blk].numpy(), np.asarray(jdn))
    assert float(up.sum()) > 0 and float(dn.sum()) > 0


@pytest.mark.parametrize("um", [False, True])
def test_grid_streamed_update_matches_jax(um):
    """The conv entry in one chunk (im2col columns, replicated error rows,
    the precomputed UM extrema) against JAX's ``grid_pulse_update_streamed``
    with one chunk of every position."""
    tcfg, jcfg = _cfgs(tile_grid=(2, 2), bl=1 if um else 10,
                       update_management=um)
    rng = np.random.default_rng(11)
    p, m, n = 40, 6, 13
    cols = rng.normal(size=(p, n)).astype(np.float32)
    dphys = (0.3 * rng.normal(size=(p, m))).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (m, n)).astype(np.float32)
    jm, maps = _maps(jcfg, m, n, 5)
    maxima = (np.abs(cols).max(), np.abs(dphys).max()) if um else None

    def get_chunk(s, start, ch):
        return (jax.lax.dynamic_slice_in_dim(s[0], start, ch),
                jax.lax.dynamic_slice_in_dim(s[1], start, ch))

    jw = _jax_run(lambda w_, c_, d_: jgrid.grid_pulse_update_streamed(
        w_, jm, (c_, d_), get_chunk, jax.random.key(3), jcfg, LR, total=p,
        chunk=p, um_maxima=None if maxima is None else tuple(
            jnp.float32(v) for v in maxima), force_reference=True),
        w, cols, dphys)
    tw = tup.pulse_update_streamed(
        _t(w), maps, (_t(cols), _t(dphys)),
        lambda s, start, n: (s[0][start:start + n], s[1][start:start + n]),
        prng.key(3), tcfg, LR, total=p, chunk=p,
        um_maxima=None if maxima is None else tuple(
            torch.tensor(v) for v in maxima))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)
    assert not np.array_equal(tw.numpy(), w)


# ---------------------------------------------------------------------------
# LeNet on a grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grid_lenet():
    """JAX's LeNet under each grid policy: its initial parameters, the
    parameters after one step of ``_batch()`` under key 5, and the logits
    of ``_batch()`` under key 5 (one compiled program for both)."""
    x, y = _batch()
    out = {}
    for policy, ref in JAX_REF.items():
        jcfg = jlenet.LeNetConfig.from_policy(jpresets.parse_policy(ref))
        pj = jlenet.init(jax.random.key(3), jcfg)
        step, opt = jcnn.make_train_step(jcfg)

        def step_and_logits(p, o, xx, yy, k, step=step, jcfg=jcfg):
            return step(p, o, xx, yy, k)[0], jlenet.apply(p, xx, k, jcfg)

        pj2, lj = _jax_run(step_and_logits, pj, opt.init(pj), jnp.asarray(x),
                           jnp.asarray(y), jax.random.key(5))
        out[policy] = (jcfg, pj, pj2, np.asarray(lj))
    return out


def test_from_jax_params_carries_grid_tiles(jax_grid_lenet):
    """Grid-configured parameters cross unchanged: the stored weights are
    never padded, the maps and seeds are the JAX package's."""
    jcfg, pj, _, _ = jax_grid_lenet[GRID_2P]
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    for name in tlenet.LAYERS:
        s = pt[name]
        assert s.meta.cfg.tile_grid == (2, 2)
        np.testing.assert_array_equal(s.w.numpy(), np.asarray(pj[name].w))
        np.testing.assert_array_equal(s.maps.bound.numpy(),
                                      np.asarray(pj[name].maps.bound))
    assert tuple(pt["K2"].w.shape) == (32, 401)


@pytest.mark.parametrize("policy", [GRID_2P, GRID_IT], ids=["2p", "it"])
def test_grid_train_step_matches_jax(policy, jax_grid_lenet):
    """One full-width LeNet step on a 2x2 grid: the port (plain block reads
    on the CPU) against the JAX package's reference route; under iterative
    BM the step's reads retry."""
    jcfg, pj, pj2, lj = jax_grid_lenet[policy]
    tcfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(policy))
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    x, y = _batch()
    with torch.no_grad():
        lt = tlenet.apply(pt, torch.from_numpy(x), prng.key(5), tcfg)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGIT_ATOL)
    tops.reset_launch_counts()
    with tmgmt.count_retries("cpu") as n:
        tcnn.make_train_step(tcfg)(pt, torch.from_numpy(x),
                                   torch.from_numpy(y), prng.key(5))
    assert set(tops.launch_counts().values()) == {0}
    assert (int(n) > 0) == (policy == GRID_IT)
    for name in tlenet.LAYERS:
        new = pt[name].w.detach().numpy()
        want = np.asarray(pj2[name].w)
        assert np.sum(new != np.asarray(pj[name].w)) > 0, name
        diff = np.abs(new - want)
        assert (diff > WEIGHT_ATOL).mean() <= MAX_MOVED_SHARE, name
        assert diff.max() <= DW_BOUND, name


def _images(n, seed=1):
    x, y = tdata.make_dataset(n, seed=seed)
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("policy", [GRID_2P, GRID_IT], ids=["2p", "it"])
def test_grid_scan_matches_python(policy):
    """Three grid steps through the epoch engine (its keys on the tape;
    under iterative BM the predicated retries, which run at alpha 0.5) and
    through the per-step loop: every tile bitwise equal."""
    cfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(policy))
    xs, ys = _images(12)
    init, loop, scan = (tlenet.init(prng.key(0), cfg) for _ in range(3))
    tcnn.python_epoch(tcnn.make_train_step(cfg), loop, xs, ys, prng.key(3),
                      prng.key(2), 0, 4)
    with tmgmt.count_retries("cpu") as n:
        tengine.make_cnn_epoch_fn(cfg, batch=4)(scan, xs, ys, prng.key(3),
                                                prng.key(2), 0)
    for name in tlenet.LAYERS:
        assert torch.equal(scan[name].w, loop[name].w), name
        assert not torch.equal(scan[name].w, init[name].w), name
    assert (int(n) > 0) == (policy == GRID_IT)


def test_iterative_grid_step_fits_the_tape():
    """An ITERATIVE grid step records every block read's key: 11 grid reads
    of 4 blocks for each of the 8 managed reads, and per update the two
    stream seeds and 4 block ctoc seeds, inside TAPE_SLOTS."""
    cfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(GRID_IT))
    x, y = _images(2)
    tape = prng.KeyTape("cpu")
    tengine.make_cnn_step_fn(cfg)(tlenet.init(prng.key(0), cfg), x, y,
                                  tape.begin())
    tape.end()
    parent, _, seeds = tape.recorded
    assert len(seeds) == 8 * 11 * 4 + 4 * (2 + 4)
    assert len(parent) + 1 < prng.TAPE_SLOTS


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "bwd"])
def test_cuda_grid_read_matches_plain(transpose, cuda):
    """The grid read on the card (one #1 launch per block) against the plain
    grid read on the card, with equal flags."""
    cfg = tdev.RPUConfig(tile_grid=(3, 2), out_bound=1.0, use_pallas=True)
    w, x = _operands(130, 77, 9, transpose, seed=6, scale=2.0)
    w, x = _t(w).to(cuda), _t(x).to(cuda)
    before = tnoisy.launches
    y, s = tgrid.grid_analog_mvm(w, x, prng.key(3), cfg, transpose=transpose)
    assert tnoisy.launches - before == 6
    yp, sp = tgrid.grid_analog_mvm(w, x, prng.key(3),
                                   dataclasses.replace(cfg, use_pallas=False),
                                   transpose=transpose)
    torch.cuda.synchronize()
    mag = float((x.abs() @ (w.abs() if transpose else w.abs().T)).max())
    assert float((y - yp).abs().max()) <= RTOL * mag
    assert torch.equal(s, sp)


@pytest.mark.cuda
def test_cuda_block_read_device_seed_and_false_go(cuda):
    """A block read with its seed in device memory equals its by-value
    read; under a false predicate it returns at once, and a by-value read
    after it is unaffected."""
    w, x = _operands(64, 40, 5, False, seed=2)
    g = tgrid.TileGrid.for_tile((64, 40), tdev.RPUConfig(tile_grid=(2, 2)))
    blk = tgrid.weight_blocks(_t(w).to(cuda), g)[1][1]
    xb = _t(x[:, 20:]).to(cuda).contiguous()
    kw = dict(sigma=0.06, alpha=1.0)
    y0, s0 = tnoisy.noisy_mvm(blk, xb, 0x5EED, **kw)
    seed = torch.tensor(0x5EED, dtype=torch.int64, device=cuda)
    y1, s1 = tnoisy.noisy_mvm(blk, xb, seed, **kw)
    no = torch.zeros((), dtype=torch.bool, device=cuda)
    tnoisy.noisy_mvm(blk, xb, seed, go=no, **kw)
    y2, s2 = tnoisy.noisy_mvm(blk, xb, 0x5EED, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert torch.equal(y0, y2) and torch.equal(s0, s2)
