"""Parity of the port's update cycle with the JAX package: device maps,
initial weights, pulse gains, signed streams, coincidence counts (the plain
version of the pulse-count kernel) and the finalize step.

Integer-valued stages — streams, counts, uniform draws, the weights'
uniform init — must agree bitwise.  The device maps come from
``jax.random.normal``, which the port rebuilds from the same threefry bits
with XLA's erfinv polynomial; numpy's ``log1p`` in it differs from XLA's by
an ulp, so normal draws agree within NORMAL_ULP ulp (about 1% of them
differ).  A map value is ``mean * (1 + spread * z)``, so it inherits that
error times the spread: maps agree within MAP_RTOL of the map's mean
(0.3 x 4 ulp of |z| <= 5.3 is 7e-7), and at least 98% of them bitwise.
``finalize``
multiplies and adds counts and maps, where XLA contracts into fused
multiply-adds: within FINALIZE_ATOL (a few ulp of |w| <= 0.6 plus ulp
noise of dw ~ 1e-3).  The JAX Pallas count kernel runs in interpret mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import device as jdev
from repro.core import management as jmgmt
from repro.core import tile as jtile
from repro.core import update as jup
from repro.kernels import ops as jops
from repro_torch.core import device as tdev
from repro_torch.core import management as tmgmt
from repro_torch.core import tile as ttile
from repro_torch.core import update as tup
from repro_torch.kernels import pulse_update as tpulse
from repro_torch.utils import prng

NORMAL_ULP = 4
MAP_RTOL = 1e-6
FINALIZE_ATOL = 2e-7
LR = 0.01


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a),
                                                        np.abs(b))))


CFGS = {
    "baseline": dict(),
    "managed": dict(bl=1, noise_management=True, bound_management=True,
                    update_management=True),
    "no_variation": dict(dw_min_dtod=0.0, dw_min_ctoc=0.0,
                         imbalance_dtod=0.0, w_bound_dtod=0.0),
}


@pytest.mark.parametrize("name,seed,rows,cols", [
    ("baseline", 5, 416, 401), ("managed", 0, 16, 26),
    ("no_variation", 9, 10, 129)])
def test_device_maps_match_jax(name, seed, rows, cols):
    """Each side draws its maps twice and must equal its own redraw
    bitwise before the two sides are compared, so a draw that moves says
    which side moved: the port's numpy float32 log1p and XLA's erfinv
    polynomial (``utils/prng.py``), or JAX's XLA CPU draw."""
    def jax_maps():
        jm = jdev.sample_device_maps(jax.random.key(seed), rows, cols,
                                     jdev.RPUConfig(**CFGS[name]))
        return {f: np.asarray(getattr(jm, f)) for f in MAP_FIELDS}

    def port_maps():
        tm = tdev.sample_device_maps(prng.key(seed), rows, cols,
                                     tdev.RPUConfig(**CFGS[name]))
        return {f: getattr(tm, f).numpy().copy() for f in MAP_FIELDS}

    jm, tm = jax_maps(), port_maps()
    for side, first, again in (("jax", jm, jax_maps()),
                               ("port", tm, port_maps())):
        for f in MAP_FIELDS:
            np.testing.assert_array_equal(
                again[f], first[f], err_msg=f"{side} redraw of {f} moved")
    cfg = tdev.RPUConfig(**CFGS[name])
    for f, mean in (("dw_up", cfg.dw_min), ("dw_dn", cfg.dw_min),
                    ("bound", cfg.w_bound)):
        _assert_map_close(tm[f], jm[f], mean)


MAP_FIELDS = ("dw_up", "dw_dn", "bound")


def _assert_map_close(a, b, mean):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= MAP_RTOL * mean
    assert np.mean(a == b) >= 0.98


@pytest.mark.parametrize("seed,shape", [(0, (16, 26)), (3, (416, 401)),
                                        (11, (7,))])
def test_threefry_draws_match_jax(seed, shape):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.random_bits(prng.key(seed), shape),
                                  np.asarray(jax.random.bits(k, shape)))
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), shape, -0.3, 0.3),
        np.asarray(jax.random.uniform(k, shape, minval=-0.3, maxval=0.3)))
    assert _ulps(prng.normal(prng.key(seed), shape).numpy(),
                 jax.random.normal(k, shape)) <= NORMAL_ULP


@pytest.mark.parametrize("d", [1, 13])
def test_init_tile_matches_jax(d):
    jcfg = jdev.RPUConfig(devices_per_weight=d)
    tcfg = tdev.RPUConfig(devices_per_weight=d)
    js = jtile.init_tile(jax.random.key(4), 32, 401, jcfg)
    w, maps, seed = ttile.init_tile(prng.key(4), 32, 401, tcfg)
    assert seed == tuple(int(v) for v in np.asarray(
        jax.random.key_data(js.seed)))
    # bitwise uniform weights, clipped by bounds that agree within MAP_RTOL
    _assert_map_close(w.numpy(), js.w, tcfg.w_bound)
    _assert_map_close(maps.bound.numpy(), js.maps.bound, tcfg.w_bound)


@pytest.mark.parametrize("bl", [1, 10])
@pytest.mark.parametrize("um", [False, True])
def test_um_factors_match_jax(bl, um):
    rng = np.random.default_rng(bl)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    d = (0.01 * rng.normal(size=(6, 5))).astype(np.float32)
    jcfg = jdev.RPUConfig(bl=bl, update_management=um)
    tcfg = tdev.RPUConfig(bl=bl, update_management=um)
    jcx, jcd = jax.jit(lambda a, b, l: jmgmt.um_factors(a, b, jcfg, l))(
        x, d, jnp.float32(LR))
    tcx, tcd = tmgmt.um_factors(_t(x), _t(d), tcfg, LR)
    assert tcx.shape == () and tcd.shape == ()
    assert float(tcx) == float(jcx) and float(tcd) == float(jcd)


@pytest.mark.parametrize("bl,row_offset", [(1, None), (10, None), (10, 7)])
def test_signed_streams_match_jax(bl, row_offset):
    rng = np.random.default_rng(bl)
    v = rng.normal(size=(5, 13)).astype(np.float32)
    js = jup.sample_signed_streams(jax.random.key(2), jnp.asarray(v),
                                   jnp.float32(0.8), bl,
                                   row_offset=row_offset)
    ts = tup.sample_signed_streams(prng.key(2), _t(v), torch.tensor(0.8),
                                   bl, row_offset=row_offset)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert 0 < float(ts.abs().mean()) < 1


def _streams(t, m, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.choice([-1.0, 0.0, 1.0], size=(t, m)).astype(np.float32)
    cols = rng.choice([-1.0, 0.0, 1.0], size=(t, n)).astype(np.float32)
    return rows, cols


@pytest.mark.parametrize("t,m,n", [(4608, 16, 26), (512, 32, 401),
                                   (80, 128, 513), (3, 5, 7)])
def test_pulse_counts_match_jax_kernel(t, m, n):
    rows, cols = _streams(t, m, n, t + m)
    jup_, jdn = jops.pulse_counts(jnp.asarray(rows), jnp.asarray(cols))
    tup_, tdn = tpulse.pulse_counts(_t(rows), _t(cols))
    np.testing.assert_array_equal(tup_.numpy(), np.asarray(jup_))
    np.testing.assert_array_equal(tdn.numpy(), np.asarray(jdn))
    # and the reference contraction of the JAX package
    rup, rdn = jup.coincidence_counts(jnp.asarray(rows), jnp.asarray(cols))
    np.testing.assert_array_equal(tup_.numpy(), np.asarray(rup))
    np.testing.assert_array_equal(tdn.numpy(), np.asarray(rdn))


@pytest.mark.parametrize("ctoc", [0.0, 0.3])
def test_finalize_counts_matches_jax(ctoc):
    rows, cols = _streams(64, 12, 9, 3)
    up, dn = tpulse.pulse_counts_plain(_t(rows), _t(cols))
    jcfg = jdev.RPUConfig(dw_min_ctoc=ctoc)
    tcfg = tdev.RPUConfig(dw_min_ctoc=ctoc)
    jm = jdev.sample_device_maps(jax.random.key(1), 12, 9, jcfg)
    maps = tdev.DeviceMaps(*(_t(getattr(jm, f))
                             for f in ("dw_up", "dw_dn", "bound")))
    w = np.random.default_rng(0).uniform(-0.6, 0.6, (12, 9)).astype(
        np.float32)
    jw = jax.jit(lambda w_, u, d: jup.finalize_counts(
        w_, jm, u, d, jax.random.key(8), jcfg))(w, up.numpy(), dn.numpy())
    tw = tup.finalize_counts(_t(w), maps, up, dn, prng.key(8), tcfg)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)


@pytest.mark.parametrize("name,d", [("baseline", 3), ("managed", 1),
                                    ("no_variation", 2)])
def test_pulse_update_matches_jax(name, d):
    """The whole update cycle on the same weights, maps, inputs and key:
    the kernel route of the JAX package (interpret mode) against the port's
    plain version."""
    kw = dict(CFGS[name], devices_per_weight=d, use_pallas=True)
    jcfg, tcfg = jdev.RPUConfig(**kw), tdev.RPUConfig(**kw)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    delta = (0.3 * rng.normal(size=(4, 6))).astype(np.float32)
    js = jtile.init_tile(jax.random.key(6), 6, 9, jcfg)
    maps = tdev.DeviceMaps(*(_t(getattr(js.maps, f))
                             for f in ("dw_up", "dw_dn", "bound")))
    jw = jax.jit(lambda w_, l: jup.pulse_update(
        w_, js.maps, jnp.asarray(x), jnp.asarray(delta), jax.random.key(9),
        jcfg, l))(js.w, jnp.float32(LR))
    tw = tup.pulse_update(_t(js.w), maps, _t(x), _t(delta), prng.key(9),
                          tcfg, LR)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)
    assert not np.array_equal(tw.numpy(), np.asarray(js.w))


def test_tile_update_regenerates_seeded_maps():
    """``tile_update`` with maps=None draws the tile's maps from its seed,
    as the JAX package's ``tile_update`` does for a seeded tile."""
    kw = dict(use_pallas=True, seeded_maps=True, bl=1)
    jcfg, tcfg = jdev.RPUConfig(**kw), tdev.RPUConfig(**kw)
    js = jtile.init_tile(jax.random.key(2), 5, 8, jcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    delta = rng.normal(size=(3, 5)).astype(np.float32)
    jw = jtile.tile_update(js, jnp.asarray(x), jnp.asarray(delta),
                           jax.random.key(3), jcfg, jnp.float32(LR)).w
    seed = tuple(int(v) for v in np.asarray(jax.random.key_data(js.seed)))
    tw = ttile.tile_update(_t(js.w), None, seed, _t(x), _t(delta),
                           prng.key(3), tcfg, LR)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=FINALIZE_ATOL)


def test_replicate_delta_layout():
    d = torch.arange(6.0).reshape(2, 3)
    r = ttile.replicate_delta(d, 3, rows_phys=9)
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(jtile.replicate_delta(jnp.asarray(d.numpy()),
                                                    3, rows_phys=9)))
    with pytest.raises(ValueError, match="physical rows"):
        ttile.replicate_delta(d, 2, rows_phys=9)


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,n", [(4608, 16, 26), (46080, 16, 26),
                                   (512, 416, 401), (8, 128, 513)])
def test_cuda_pulse_counts_bitwise(t, m, n, cuda):
    rows, cols = _streams(t, m, n, t)
    up, dn = tpulse.pulse_counts(_t(rows).to(cuda), _t(cols).to(cuda))
    pup, pdn = tpulse.pulse_counts_plain(_t(rows), _t(cols))
    torch.cuda.synchronize()
    assert torch.equal(up.cpu(), pup) and torch.equal(dn.cpu(), pdn)
