"""Parity of the port's conv mapping with the JAX package: geometry, the
im2col columns, the window max, the NM scale and col2im (data movement and
maxima: bitwise), and the implicit-im2col managed conv read (the plain
version of the conv kernel) against the JAX package's conv kernel in
interpret mode.

Read tolerance: y within READ_RTOL of the largest |y| of the case — f32
reassociation over <= 401 terms (the port reads the tap-major patch with a
matmul, the TPU kernel its own blocked dot), ulp-level Box-Muller
differences, scaled by the NM scale and the two-phase factor 16.
Saturation flags must be equal; every fixture is checked to keep each
pre-clip value at least MARGIN away from +-alpha.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import conv_mapping as jcm
from repro.core.device import RPUConfig as JCfg
from repro.kernels import conv_mvm as jconv
from repro.kernels import ops as jops
from repro_torch.core import conv_mapping as tcm
from repro_torch.core.device import RPUConfig as TCfg
from repro_torch.kernels import conv_mvm as tconv
from repro_torch.kernels import ops as tops
from repro_torch.utils import prng

READ_RTOL = 1e-5
MARGIN = 1e-4

# (B, H, W, C, kernel, out, stride, padding, dilation)
GEOMS = {
    "K1": (2, 28, 28, 1, 5, 16, 1, "VALID", 1),
    "K2": (2, 12, 12, 16, 5, 32, 1, "VALID", 1),
    "strided": (1, 9, 11, 3, 3, 4, 2, "SAME", 1),
    "dilated": (2, 10, 10, 2, (3, 2), 5, 1, ((1, 2), (0, 1)), 2),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _geoms(name, bias=True):
    b, h, w, c, k, _, s, p, d = GEOMS[name]
    args = ((b, h, w, c), k, s, p, d, bias)
    return jcm.conv_geometry(*args), tcm.conv_geometry(*args)


def _volume(name, seed=0):
    b, h, w, c = GEOMS[name][:4]
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(
        np.float32)


@pytest.mark.parametrize("name,bias", [("K1", True), ("K2", True),
                                       ("strided", False),
                                       ("dilated", True)])
def test_geometry_columns_and_maxima_match_jax(name, bias):
    jg, tg = _geoms(name, bias)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    x = _volume(name)

    @jax.jit
    def jax_side(v):
        xp = jcm._pad_volume(v, jg)
        return (xp, jcm.gather_columns(xp, jg, 0, jg.positions),
                jcm.window_absmax(xp, jg), jcm._conv_nm_scale(xp, jg))

    tx = tcm._pad_volume(_t(x), tg)
    got = (tx, tcm.gather_columns(tx, tg, 0, tg.positions),
           tcm.window_absmax(tx, tg),
           tcm._conv_nm_scale(tx, tg))
    for a, b in zip(got, jax_side(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_col2im_matches_jax_bitwise(name):
    jg, tg = _geoms(name)
    z = np.random.default_rng(1).normal(
        size=(jg.positions, jg.features)).astype(np.float32)
    zeros = np.zeros((jg.b, jg.h, jg.w, jg.c), np.float32)
    want = jcm.col2im_add(jnp.asarray(z), jg, 0, jg.positions,
                          jnp.asarray(zeros))
    got = tcm.col2im_add(_t(z), tg, 0, tg.positions, _t(zeros))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_im2col_matches_jax():
    x = _volume("dilated")
    kw = dict(kernel=(3, 2), stride=1, padding=((1, 2), (0, 1)),
              dilation=2)
    np.testing.assert_array_equal(
        tcm.im2col(_t(x), **kw).numpy(),
        np.asarray(jcm.im2col(jnp.asarray(x), **kw)))


def test_tap_major_layout_matches_jax():
    jg, tg = _geoms("K2")
    w = np.random.default_rng(2).normal(size=(32, jg.cols)).astype(
        np.float32)
    jw = np.asarray(jconv.tap_major_weights(jnp.asarray(w), jg, 1, 128))
    tw = tconv.tap_major_weights(_t(w), tg).numpy()
    np.testing.assert_array_equal(tw, jw[:jg.cols, :32].T)
    xp = _volume("K2")
    p_img = jg.oh * jg.ow
    jp_ = np.asarray(jconv.assemble_patch(jnp.asarray(xp[0]), jg, p_img,
                                          p_img, 512))
    np.testing.assert_array_equal(
        tconv.assemble_patch(_t(xp), tg).numpy()[:p_img], jp_[:, :jg.cols])


# (geometry, nm_forward, two_phase BM, #_d, input scale)
READ_CASES = [
    ("K1", False, True, 1, 6.0),
    ("K2", True, True, 13, 1.0),
    ("K2", False, False, 1, 2.0),
    ("strided", True, False, 3, 1.0),
    ("dilated", False, True, 1, 30.0),
]


def _read_fixture(name, d, scale, seed):
    _, tg = _geoms(name)
    out = GEOMS[name][5]
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(out * d, tg.cols)) * 0.3).astype(np.float32)
    x = (_volume(name, seed) * scale).astype(np.float32)
    return w, x


@pytest.mark.parametrize("case", READ_CASES, ids=str)
def test_conv_read_matches_jax_kernel(case):
    name, nm, bm, d, scale = case
    alpha = 4.0
    kw = dict(use_pallas=True, noise_management=nm, nm_forward=nm,
              bound_management=bm, bm_mode="two_phase", out_bound=alpha,
              devices_per_weight=d)
    jg, tg = _geoms(name)
    w, x = _read_fixture(name, d, scale, seed=len(name) + d)
    xp = tcm._pad_volume(_t(x), tg)
    nm_s = (tcm._conv_nm_scale(xp, tg) if nm
            else torch.ones(tg.positions, 1))
    # margin: no pre-clip value within MARGIN of the bound
    cols = tcm.gather_columns(xp, tg, 0, tg.positions)
    raw = (cols / nm_s) @ _t(w).T
    for s in ((1.0, 16.0) if bm else (1.0,)):
        assert float(((raw / s).abs() - alpha).abs().min()) > MARGIN
    yj, sj = jops.conv_managed_mvm(jnp.asarray(w), jnp.asarray(xp.numpy()),
                                   jg, jnp.asarray(nm_s.numpy()),
                                   jax.random.key(4), JCfg(**kw))
    yt, st = tops.conv_managed_mvm(_t(w), xp, tg, nm_s, prng.key(4),
                                   TCfg(**kw))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=READ_RTOL * np.abs(yj).max())


def test_conv_read_cases_saturate():
    """The read fixtures cover rows that saturate (first read, or both)."""
    sat_any = False
    for name, nm, bm, d, scale in READ_CASES:
        _, tg = _geoms(name)
        w, x = _read_fixture(name, d, scale, seed=len(name) + d)
        xp = tcm._pad_volume(_t(x), tg)
        _, sat = tconv.conv_managed_mvm(
            _t(w), xp, tg, torch.ones(tg.positions, 1), (1, 2), sigma=0.06,
            alpha=4.0, two_phase=bm, d_avg=d)
        sat_any |= bool(sat.any())
    assert sat_any


@pytest.mark.parametrize("nm", [False, True])
def test_conv_layer_forward_matches_jax(nm):
    """``conv_mapping.apply`` (the layer's forward cycle) against the JAX
    layer under the conv-kernel route."""
    from repro.core.tile import TileState
    kw = dict(use_pallas=True, noise_management=nm, nm_forward=nm,
              bound_management=True, bm_mode="two_phase")
    jg, tg = _geoms("K2")
    w, x = _read_fixture("K2", 1, 1.0, seed=9)
    state = TileState(w=jnp.asarray(w), maps=None, seed=jax.random.key(0))
    yj = jcm.apply(state, jnp.asarray(x), jax.random.key(6), JCfg(**kw),
                   0.01, kernel=5)
    yt = tcm.apply(_t(w), _t(x), prng.key(6), TCfg(**kw), 0.01, kernel=5)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=READ_RTOL * np.abs(yj).max())


def test_conv_kernel_routing():
    _, tg = _geoms("K2")
    assert tconv.conv_kernel_eligible(TCfg(use_pallas=True), tg, (32, 401))
    assert not tconv.conv_kernel_eligible(TCfg(), tg, (32, 401))
    assert not tconv.conv_kernel_eligible(
        TCfg(use_pallas=True, bound_management=True), tg, (32, 401))
    assert not tconv.conv_kernel_eligible(
        TCfg(use_pallas=True, max_array_cols=400), tg, (32, 401))


CONV_PLANS = [
    # (physical outputs, contraction, positions)
    #     -> (tile_m, tile_n, one block holds every column, parts)
    ((16, 26, 4608), (64, 16, True, 1)),     # K1 at batch 8
    ((32, 401, 512), (32, 32, True, 3)),     # K2
    ((416, 401, 512), (32, 32, False, 3)),   # K2 with 13 devices per weight
    ((16, 26, 1152), (64, 16, True, 1)),     # K1 at batch 2
    ((4, 27, 100), (64, 16, True, 1)), ((17, 401, 128), (32, 32, True, 3)),
    ((48, 200, 1000), (64, 64, True, 1)), ((64, 64, 64), (64, 64, True, 1)),
    ((65, 1000, 50), (32, 32, False, 7)),
]


@pytest.mark.parametrize("args,want", CONV_PLANS, ids=str)
def test_conv_read_plan(args, want):
    assert tuple(tconv.plan(*args)) == want


def test_conv_plan_takes_the_narrowest_tile():
    """The block holds every physical output wherever a tile of the set is
    that wide, with the narrowest such tile (so no column block is mostly
    padding); wider arrays select across blocks.  The contraction splits
    into the fewest parts that give PARTS_TARGET blocks, unless MAX_PARTS
    or the least part depth caps them."""
    for out, k, pos in itertools.product(range(1, 600, 7), (9, 26, 401),
                                         (64, 512, 4608)):
        p = tconv.plan(out, k, pos)
        fits = [t for t in tconv.ONE_TILES if out <= t[1]]
        if fits:
            assert p[:3] == (fits[0][0], fits[0][1], True)
            assert p.tile_n < 2 * out or p.tile_n == tconv.ONE_TILES[0][1]
        else:
            assert p[:3] == (*tconv.CROSS_TILE, False)
        tiles = -(-pos // p.tile_m) * -(-out // p.tile_n)
        cap = max(1, min(tconv.MAX_PARTS, k // tconv.MIN_PART_DEPTH))
        assert 1 <= p.parts <= cap
        assert p.parts == cap or tiles * p.parts >= tconv.PARTS_TARGET
        assert p.parts == 1 or tiles * (p.parts - 1) < tconv.PARTS_TARGET


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", READ_CASES, ids=str)
def test_cuda_conv_read_matches_plain(case, cuda):
    name, nm, bm, d, scale = case
    _, tg = _geoms(name)
    w, x = _read_fixture(name, d, scale, seed=len(name) + d)
    xp = tcm._pad_volume(_t(x), tg)
    nm_s = tcm._conv_nm_scale(xp, tg) if nm else torch.ones(tg.positions, 1)
    kw = dict(sigma=0.06, alpha=4.0, two_phase=bm, d_avg=d)
    y, s = tconv.conv_managed_mvm(_t(w).to(cuda), xp.to(cuda), tg,
                                  nm_s.to(cuda), (3, 4), **kw)
    yp, sp = tconv.conv_managed_mvm_plain(_t(w), xp, tg, nm_s, (3, 4), **kw)
    torch.cuda.synchronize()
    assert torch.equal(s.cpu(), sp)
    torch.testing.assert_close(y.cpu(), yp, rtol=0,
                               atol=READ_RTOL * float(yp.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 13])
@pytest.mark.parametrize("name", ["K1", "K2"])
def test_cuda_conv_read_is_one_launch(name, d, cuda):
    """Every conv read at LeNet's widths (batch 8) is one ordinary kernel
    launch with no memset: ten reads make ten ``cudaLaunchKernel`` calls,
    and every kernel record the profiler keeps is the conv read's."""
    if name == "K1" and d > 1:
        pytest.skip("K1 has one device per weight")
    b, h, w_, c, k, out, st, pad, dil = GEOMS[name]
    tg = tcm.conv_geometry((8, h, w_, c), k, st, pad, dil, True)
    g = torch.Generator().manual_seed(d)
    w = (torch.randn(out * d, tg.cols, generator=g) * 0.3).to(cuda)
    xp = tcm._pad_volume(torch.randn(8, h, w_, c, generator=g), tg).to(cuda)
    nm_s = torch.ones(tg.positions, 1, device=cuda)
    kw = dict(sigma=0.06, alpha=4.0, two_phase=True, d_avg=d)
    tconv.conv_managed_mvm(w, xp, tg, nm_s, (3, 4), **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            tconv.conv_managed_mvm(w, xp, tg, nm_s, (3, 4), **kw)
        torch.cuda.synchronize()
    host, kernels = {}, {}
    for e in prof.key_averages():
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        (kernels if on_device else host)[e.key] = e.count
    launched = {k: n for k, n in host.items()
                if k.startswith(("cudaLaunch", "cudaMemset"))}
    assert launched == {"cudaLaunchKernel": 10}, launched
    assert kernels and all("conv_read" in k for k in kernels), kernels
