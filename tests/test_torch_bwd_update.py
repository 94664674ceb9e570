"""Parity of the port's fused backward+update (the plain versions of the
dense and conv entries of its CUDA kernel) with the JAX package.

The conv entry is held against the JAX package's conv kernel
(``conv_bwd_update_pallas``) in interpret mode.  The JAX dense kernel
cannot be traced by the installed jax (its ``pl.store`` is gone), so the
dense entry is held against the JAX package's separate cycles on its
reference path — the managed transpose read and the counts of the update's
streams — which its own tests pin bitwise to its kernels.
Within the port, the fused route must equal the separate one bitwise.

Counts are integers: bitwise.  Reads: within READ_RTOL of the largest |z|
(f32 reassociation over <= 416 terms, ulp-level Box-Muller differences,
scaled by the NM scale and the two-phase factor 16); saturation flags equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import conv_mapping as jcm
from repro.core import management as jmgmt
from repro.core import tile as jtile
from repro.core import update as jup
from repro.core.device import RPUConfig as JCfg
from repro.kernels import ops as jops
from repro_torch.core import analog_linear as tal
from repro_torch.core import conv_mapping as tcm
from repro_torch.core import device as tdev
from repro_torch.core.device import RPUConfig as TCfg
from repro_torch.kernels import bwd_update_mvm as tbwd
from repro_torch.kernels import ops as tops
from repro_torch.utils import prng

READ_RTOL = 1e-5
LR = 0.01


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfg_kw(nm, bm, um, d, bl):
    return dict(use_pallas=True, fuse_bwd_update=True, noise_management=nm,
                bound_management=bm, bm_mode="two_phase",
                update_management=um, devices_per_weight=d, bl=bl,
                out_bound=4.0)


# (B, out_f, n_cols, nm, bm, um, #_d, BL, row_offset, error scale)
DENSE = [
    (8, 128, 513, True, True, True, 1, 1, None, 1.0),     # W3, managed
    (8, 10, 129, True, True, False, 1, 10, None, 3.0),    # W4, nm_bm
    (5, 13, 20, False, False, True, 3, 10, 7, 0.5),       # #_d, row offset
    (6, 9, 31, False, True, False, 1, 2, 2 ** 32 - 3, 40.0),
]


def _dense_fixture(b, out_f, n, d, scale, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(out_f * d, n))).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    g = (scale * rng.normal(size=(b, out_f))).astype(np.float32)
    return w, x, g


@pytest.mark.parametrize("case", DENSE, ids=str)
def test_dense_fused_matches_jax_separate(case):
    b, out_f, n, nm, bm, um, d, bl, off, scale = case
    kw = _cfg_kw(nm, bm, um, d, bl)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    w, x, g = _dense_fixture(b, out_f, n, d, scale, seed=b + n)
    g_rep = np.tile(g, (1, d))
    z, sat, up, dn = tops.bwd_update_mvm(_t(w), _t(x), _t(g_rep),
                                         prng.key(1), prng.key(2),
                                         prng.key(3), tcfg, LR,
                                         row_offset=off)
    # the JAX separate route (its reference path): managed transpose read,
    # counts of the streams of x and -g
    ref = dataclasses.replace(jcfg, use_pallas=False)

    @jax.jit
    def jax_side(w_, x_, g_):
        z_, sat_ = jtile.managed_mvm_reference(w_, g_, jax.random.key(1),
                                               ref, transpose=True,
                                               backward=True)
        cx, cd = jmgmt.um_factors(x_, -g_, ref, jnp.float32(LR))
        return (z_, sat_) + jup.stream_counts(x_, -g_, cx, cd,
                                              jax.random.key(2),
                                              jax.random.key(3), ref,
                                              row_offset=off)

    zj, satj, upj, dnj = jax_side(jnp.asarray(w), jnp.asarray(x),
                                  jnp.asarray(g_rep))
    np.testing.assert_array_equal(up.numpy(), np.asarray(upj))
    np.testing.assert_array_equal(dn.numpy(), np.asarray(dnj))
    assert float(up.sum() + dn.sum()) > 0
    np.testing.assert_array_equal(sat.numpy(), np.asarray(satj))
    zj = np.asarray(zj)
    np.testing.assert_allclose(z.numpy(), zj, rtol=0,
                               atol=READ_RTOL * np.abs(zj).max())


# (geometry (B, H, W, C, k, out), nm, bm, um, #_d, BL)
CONV = [
    ((2, 28, 28, 1, 5, 16), True, True, True, 1, 1),      # K1, managed
    ((2, 12, 12, 16, 5, 32), True, True, True, 13, 1),    # K2, paper #_d
    ((2, 12, 12, 16, 5, 32), True, False, False, 1, 10),  # K2, nm_bm-like
    ((1, 7, 9, 3, 3, 4), False, True, False, 2, 3),
]


def _conv_fixture(shape, d, seed):
    b, h, w_, c, k, out = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w_, c)).astype(np.float32)
    geom = tcm.conv_geometry(x.shape, k)
    w = (0.3 * rng.normal(size=(out * d, geom.cols))).astype(np.float32)
    g2 = (2.0 * rng.normal(size=(geom.positions, out))).astype(np.float32)
    return x, w, np.tile(g2, (1, d)), geom


@pytest.mark.parametrize("case", CONV, ids=str)
def test_conv_fused_matches_jax_kernel(case):
    shape, nm, bm, um, d, bl = case
    kw = _cfg_kw(nm, bm, um, d, bl)
    x, w, dr, tg = _conv_fixture(shape, d, seed=sum(shape) + d)
    jg = jcm.conv_geometry(x.shape, shape[4])
    xm = np.float32(max(1.0, np.abs(x).max()))
    dm = np.float32(np.abs(dr).max())
    zj, sj, upj, dnj = jops.conv_bwd_update_mvm(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(dr), jg,
        jax.random.key(1), jax.random.key(2), jax.random.key(3), JCfg(**kw),
        jnp.float32(LR), um_maxima=(jnp.float32(xm), jnp.float32(dm)))
    maxima = (torch.tensor(xm), torch.tensor(dm)) if um else None
    z, s, up, dn = tops.conv_bwd_update_mvm(
        _t(w), _t(x), _t(dr), tg, prng.key(1), prng.key(2), prng.key(3),
        TCfg(**kw), LR, um_maxima=maxima)
    np.testing.assert_array_equal(up.numpy(), np.asarray(upj))
    np.testing.assert_array_equal(dn.numpy(), np.asarray(dnj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    zj = np.asarray(zj)
    np.testing.assert_allclose(z.numpy(), zj, rtol=0,
                               atol=READ_RTOL * np.abs(zj).max())


def _maps(rows, cols, seed):
    return tdev.sample_device_maps(prng.key(seed), rows, cols, TCfg())


@pytest.mark.parametrize("d", [1, 3])
def test_dense_fused_route_bitwise_separate(d):
    """``backward_cycles`` fused and separate give the same ``x_bar`` and
    ``w_bar`` bitwise (the layer's two routes)."""
    w, x, g = _dense_fixture(4, 7, 12, d, 1.0, seed=d)
    maps = _maps(7 * d, 12, seed=d)
    out = {}
    for fuse in (True, False):
        cfg = TCfg(**dict(_cfg_kw(True, True, True, d, 10),
                          fuse_bwd_update=fuse))
        out[fuse] = tal.backward_cycles(cfg, _t(w), maps, _t(x), _t(g),
                                        prng.key(5), prng.key(6), LR)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [1, 13])
def test_conv_fused_route_bitwise_separate(d):
    x, w, dr, geom = _conv_fixture((2, 12, 12, 16, 5, 32), d, seed=d)
    g = _t(dr[:, :32]).reshape(geom.b, geom.oh, geom.ow, 32)
    maps = _maps(32 * d, geom.cols, seed=d)
    cfg = TCfg(**_cfg_kw(True, True, True, d, 1))
    fused = tcm._fused_bwd_update(cfg, geom, _t(w), maps, _t(x), g,
                                  prng.key(5), prng.key(6), LR)
    sep = (tcm._stream_backward(cfg, geom, _t(w), g, prng.key(5)),
           tcm._stream_pulse_w_bar(cfg, geom, _t(w), maps, _t(x), g,
                                   prng.key(6), LR))
    for a, b in zip(fused, sep):
        assert torch.equal(a, b)


def test_eligibility_gates():
    on = TCfg(**_cfg_kw(True, True, True, 1, 1))
    assert tbwd.bwd_update_eligible(on, (128, 513))
    assert tbwd.bwd_update_eligible(on, (416, 401))
    for off in (TCfg(use_pallas=True), TCfg(fuse_bwd_update=True),
                TCfg(use_pallas=True, fuse_bwd_update=True,
                     bound_management=True),
                TCfg(use_pallas=True, fuse_bwd_update=True,
                     max_array_rows=64)):
        assert not tbwd.bwd_update_eligible(off, (128, 513))


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_kernel_matches(got, want):
    z, s, up, dn = (t.cpu() for t in got)
    zp, sp, upp, dnp = want
    assert torch.equal(up, upp) and torch.equal(dn, dnp)
    assert torch.equal(s, sp)
    torch.testing.assert_close(z, zp, rtol=0,
                               atol=READ_RTOL * float(zp.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE, ids=str)
def test_cuda_dense_fused_matches_plain(case, cuda):
    b, out_f, n, nm, bm, um, d, bl, off, scale = case
    w, x, g = _dense_fixture(b, out_f, n, d, scale, seed=b + n)
    d2d = _t(np.tile(g, (1, d)))
    nm_s = d2d.abs().amax(1, keepdim=True)
    gains = torch.tensor([0.9, 1.7])
    upd = (11, 12, int(off or 0))
    kw = dict(sigma=0.06, alpha=4.0, two_phase=bm, bl=bl)
    got = tbwd.bwd_update_mvm(_t(w).to(cuda), d2d.to(cuda), _t(x).to(cuda),
                              nm_s.to(cuda), (5, 6), upd, gains.to(cuda),
                              **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches(got, tbwd.bwd_update_mvm_plain(
        _t(w), d2d, _t(x), nm_s, (5, 6), upd, gains, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV, ids=str)
def test_cuda_conv_fused_matches_plain(case, cuda):
    shape, nm, bm, um, d, bl = case
    x, w, dr, geom = _conv_fixture(shape, d, seed=sum(shape) + d)
    nm_s = _t(dr).abs().amax(1, keepdim=True)
    gains = torch.tensor([0.9, 1.7])
    kw = dict(sigma=0.06, alpha=4.0, two_phase=bm, bl=bl)
    got = tbwd.conv_bwd_update(_t(w).to(cuda), _t(x).to(cuda),
                               _t(dr).to(cuda), geom, nm_s.to(cuda), (5, 6),
                               (11, 12), gains.to(cuda), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches(got, tbwd.conv_bwd_update_plain(
        _t(w), _t(x), _t(dr), geom, nm_s, (5, 6), (11, 12), gains, **kw))


# ---------------------------------------------------------------------------
# The kernel's plan (host arithmetic: runs without a card)
# ---------------------------------------------------------------------------

def _conv_plan_shape(shape, d, bl):
    b, h, w_, c, k, out = shape
    geom = tcm.conv_geometry((b, h, w_, c), k)
    return geom.positions, out * d, geom.cols, bl


# (rows, m_phys, n_cols, BL) and the expected (one, read parts, slot
# parts) at LeNet's shapes (batch 8); None for the odd test shapes
PLAN_CASES = [
    ((4608, 16, 26, 1), (True, 1, 72)),        # K1, managed
    ((4608, 16, 26, 10), (True, 1, 360)),      # K1, nm_bm
    ((512, 32, 401, 1), (False, 1, 8)),        # K2
    ((512, 416, 401, 1), (False, 3, 4)),       # K2, 13 devices per weight
    ((8, 128, 513, 1), (False, 1, 1)),         # W3
    ((8, 10, 129, 10), (False, 1, 1)),         # W4
] + [((c[0], c[1] * c[6], c[2], c[7]), None) for c in DENSE] + [
    (_conv_plan_shape(c[0], c[4], c[5]), None) for c in CONV]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: str(c[0]))
def test_plan_covers_contraction_and_slots(case):
    (rows, m, n, bl), want = case
    for two_phase in (True, False):
        p = tbwd.plan(rows, m, n, bl, two_phase)
        # the read's contraction: ordered parts of 16-row k-tiles, each
        # non-empty, covering [0, m) exactly
        assert p.read_len % 16 == 0 and 1 <= p.read_parts <= 8
        bounds = [(q * p.read_len, min(m, (q + 1) * p.read_len))
                  for q in range(p.read_parts)]
        assert bounds[0][0] == 0 and bounds[-1][1] == m
        assert all(a < b for a, b in bounds)
        assert all(bounds[i][1] == bounds[i + 1][0]
                   for i in range(len(bounds) - 1))
        # the stream slots: parts of whole staging rounds covering [0, T)
        t = rows * bl
        assert p.slot_len % tbwd.SLOT_ROUND == 0
        slots = [(q * p.slot_len, min(t, (q + 1) * p.slot_len))
                 for q in range(p.slot_parts)]
        assert slots[-1][1] == t and all(a < b for a, b in slots)
        # one block holds every column only where the tile is that wide
        assert (p.tile_m, p.tile_n) == tbwd.TILE
        assert p.one == (n <= p.tile_n)
        # scratch: int32 flags, tickets (row tiles, read tiles, device
        # tiles) and the counts' atomic sums; float32 second reads, the
        # read's partial planes and, where few slot parts meet, a pair of
        # count planes per part
        row_tiles = -(-rows // p.tile_m)
        tiles = row_tiles * -(-n // p.tile_n)
        dev_tiles = -(-m // 32) * -(-n // 32)
        assert p.sum_planes == (1 < p.slot_parts <= tbwd.MAX_PLANE_PARTS)
        atomic = p.slot_parts > 1 and not p.sum_planes
        assert p.ints == (2 * rows + row_tiles + tiles + dev_tiles
                          + 2 * m * n * atomic)
        assert p.floats == (rows * n * (two_phase and not p.one)
                            + rows * n * p.read_parts * (p.read_parts > 1)
                            + 2 * m * n * p.slot_parts * p.sum_planes)
        if want is not None:
            assert (p.one, p.read_parts, p.slot_parts) == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE, ids=str)
def test_cuda_dense_back_to_back_matches_plain(case, cuda):
    """Two calls with different inputs, no synchronise between: the second
    finds the scratch as the first left it (zeroed)."""
    b, out_f, n, nm, bm, um, d, bl, off, scale = case
    w, x, g = _dense_fixture(b, out_f, n, d, scale, seed=b + n)
    gains = torch.tensor([0.9, 1.7])
    kw = dict(sigma=0.06, alpha=4.0, two_phase=bm, bl=bl)
    calls = []
    for i, s in enumerate((1.0, 30.0)):
        d2d = _t(np.tile(g, (1, d)) * s)
        nm_s = d2d.abs().amax(1, keepdim=True) if nm else torch.ones(b, 1)
        calls.append((d2d, nm_s, (5 + i, 6), (11, 12 + i, int(off or 0))))
    got = [tbwd.bwd_update_mvm(_t(w).to(cuda), d_.to(cuda), _t(x).to(cuda),
                               n_.to(cuda), rs, us, gains.to(cuda), **kw)
           for d_, n_, rs, us in calls]
    torch.cuda.synchronize()
    for (d_, n_, rs, us), out in zip(calls, got):
        _assert_kernel_matches(out, tbwd.bwd_update_mvm_plain(
            _t(w), d_, _t(x), n_, rs, us, gains, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV, ids=str)
def test_cuda_conv_back_to_back_matches_plain(case, cuda):
    shape, nm, bm, um, d, bl = case
    x, w, dr, geom = _conv_fixture(shape, d, seed=sum(shape) + d)
    gains = torch.tensor([0.9, 1.7])
    kw = dict(sigma=0.06, alpha=4.0, two_phase=bm, bl=bl)
    calls = []
    for i, s in enumerate((1.0, 30.0)):
        d_ = _t(dr * s)
        nm_s = (d_.abs().amax(1, keepdim=True) if nm
                else torch.ones(geom.positions, 1))
        calls.append((d_, nm_s, (5 + i, 6), (11, 12 + i)))
    got = [tbwd.conv_bwd_update(_t(w).to(cuda), _t(x).to(cuda), d_.to(cuda),
                                geom, n_.to(cuda), rs, us, gains.to(cuda),
                                **kw)
           for d_, n_, rs, us in calls]
    torch.cuda.synchronize()
    for (d_, n_, rs, us), out in zip(calls, got):
        _assert_kernel_matches(out, tbwd.conv_bwd_update_plain(
            _t(w), _t(x), d_, geom, n_, rs, us, gains, **kw))
