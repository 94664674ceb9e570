"""Parity of the port's analog reads with the JAX package's kernel-backed
reads.

The port's ``kernels.ops.noisy_mvm`` / ``managed_mvm`` run their plain
PyTorch versions here (CPU tensors); ``repro.kernels.ops`` runs the Pallas
kernels in interpret mode on the CPU.  Cases span NM x BM {off, two_phase,
iterative} x #_d {1, 3} x n_seg {1, 2} x transpose; iterative BM goes
through ``management.with_management`` over the raw read in both packages.

Tolerances: y within 1e-5 relative to the largest |y| of the case — f32
matmul reassociation over <= 80 terms, ulp-level Box-Muller differences,
both scaled by the NM scale and the two-phase factor 16.  Saturation flags
must be equal: every fixture is checked to keep each pre-clip value at
least 1e-4 away from +-alpha, so ulp noise cannot flip a flag.

Kernel cases (the CUDA kernels against their plain versions) need the card
and skip here.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import management as jmgmt
from repro.core import tile as jtile
from repro.core.device import RPUConfig as JCfg
from repro.kernels import ops as jops
from repro_torch.core import management as tmgmt
from repro_torch.core import tile as ttile
from repro_torch.core.device import RPUConfig as TCfg
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import managed_mvm as tmanaged
from repro_torch.kernels import noisy_mvm as tnoisy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.utils import prng

RTOL = 1e-5
MARGIN = 1e-4
ALPHA, SIGMA = 4.0, 0.06
OUT_F, K = 24, 40

# (nm, bm, d, n_seg, transpose); bm in {"off", "two_phase", "iterative"}
FULL = [c for c in itertools.product(
    (False, True), ("off", "two_phase", "iterative"), (1, 3), (1, 2),
    (False, True)) if not (c[4] and c[2] > 1)]
TIER1 = [
    (False, "off", 1, 1, False),
    (True, "two_phase", 1, 1, False),
    (True, "two_phase", 3, 2, False),
    (False, "two_phase", 1, 2, True),
    (True, "iterative", 1, 2, False),
    (False, "iterative", 3, 1, False),
    (True, "iterative", 1, 1, True),
    (True, "off", 3, 2, False),
]


def _cfg_kw(nm, bm, d, n_seg, tr):
    rows = K if tr else d * OUT_F
    return dict(read_noise=SIGMA, out_bound=ALPHA, noise_management=nm,
                nm_forward=True, bound_management=bm != "off",
                bm_mode="two_phase" if bm == "two_phase" else "iterative",
                devices_per_weight=d, use_pallas=True,
                max_array_cols=10 ** 9 if tr else -(-K // n_seg),
                max_array_rows=-(-rows // n_seg) if tr else 10 ** 9)


def _data(seed, d, tr):
    rng = np.random.default_rng(seed)
    shape = (K, OUT_F) if tr else (d * OUT_F, K)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x = (rng.standard_normal((2, 5, K)) * 1.5).astype(np.float32)
    return w, x


def _port_read(case, w, x, key):
    nm, bm, d, n_seg, tr = case
    cfg = TCfg(**_cfg_kw(*case))
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    if bm == "iterative":
        mvm = lambda xx, kk: ttile.analog_mvm(wt, xx, kk, cfg, transpose=tr)
        y, sat = tmgmt.with_management(mvm, xt, key, cfg, backward=tr)
        y = ttile._replica_mean(y, 1 if tr else d)
    else:
        y, sat = tops.managed_mvm(wt, xt, key, cfg, transpose=tr,
                                  backward=tr)
    return y.numpy(), sat.numpy()


def _jax_read(case, w, x, seed):
    nm, bm, d, n_seg, tr = case
    cfg = JCfg(**_cfg_kw(*case))
    key = jax.random.key(seed)
    wj, xj = jax.numpy.asarray(w), jax.numpy.asarray(x)
    if bm == "iterative":
        mvm = lambda xx, kk: jtile.analog_mvm(wj, xx, kk, cfg, transpose=tr)
        y, sat = jmgmt.with_management(mvm, xj, key, cfg, backward=tr)
        y = jtile._replica_mean(y, 1 if tr else d)
    else:
        y, sat = jops.managed_mvm(wj, xj, key, cfg, transpose=tr,
                                  backward=tr)
    return np.asarray(y), np.asarray(sat)


def _fixture(case, monkeypatch):
    """Data whose every pre-clip value stays MARGIN away from +-alpha (the
    first of a few data seeds that does), with the port's result."""
    margins = []
    real = tnoisy.read_segment

    def recording(v, seed_mixed, e, n_total, sigma, alpha):
        out = real(v, seed_mixed, e, n_total, sigma, alpha)
        pre = v if sigma == 0.0 else v + sigma * tnoisy.fastrng.normal_at(
            seed_mixed, e, n_total)
        margins.append(float((pre.abs() - alpha).abs().min()))
        return out

    monkeypatch.setattr(tnoisy, "read_segment", recording)
    monkeypatch.setattr(tmanaged, "read_segment", recording)
    for attempt in range(8):
        seed = 1000 * attempt + sum(
            (i + 1) * int(v) for i, v in enumerate(case[2:]))
        seed += 7 * case[0] + {"off": 0, "two_phase": 1, "iterative": 2}[
            case[1]]
        w, x = _data(seed, case[2], case[4])
        margins.clear()
        y, sat = _port_read(case, w, x, prng.key(seed))
        if min(margins) >= MARGIN:
            monkeypatch.undo()
            return seed, w, x, y, sat
    raise AssertionError("no fixture seed keeps the margin")


def _check(case, monkeypatch):
    seed, w, x, y, sat = _fixture(case, monkeypatch)
    yj, satj = _jax_read(case, w, x, seed)
    assert y.shape == yj.shape == (2, 5, OUT_F)
    np.testing.assert_array_equal(sat, satj)
    np.testing.assert_allclose(y, yj, rtol=0,
                               atol=RTOL * float(np.abs(yj).max()))


@pytest.mark.parametrize("case", TIER1, ids=str)
def test_read_matches_jax(case, monkeypatch):
    _check(case, monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("case", FULL, ids=str)
def test_read_matches_jax_full(case, monkeypatch):
    _check(case, monkeypatch)


@pytest.mark.parametrize("case", [c for c in TIER1 if c[1] != "iterative"],
                         ids=str)
def test_managed_read_matches_port_reference(case):
    """The fused managed read (the kernel's plain version) against the
    port's unfused reference pipeline (NM once, BM over raw reads, digital
    replica mean): same key discipline, so same noise; f32 tolerance as
    above (the fused read rescales after the product, the reference
    before)."""
    nm, bm, d, n_seg, tr = case
    cfg = TCfg(**_cfg_kw(*case))
    w, x = _data(5, d, tr)
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    y, sat = tops.managed_mvm(wt, xt, prng.key(8), cfg, transpose=tr,
                              backward=tr)
    yr, satr = tref.managed_mvm_ref(wt, xt, prng.key(8), cfg, transpose=tr,
                                    backward=tr)
    yr = ttile._replica_mean(yr, 1 if tr else d)
    np.testing.assert_array_equal(sat.numpy(), satr.numpy())
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=0,
                               atol=RTOL * float(yr.abs().max()))


def test_fixtures_exercise_saturation():
    """The sample is not vacuous: some rows saturate and some do not."""
    w, x = _data(3, 1, False)
    cfg = TCfg(**_cfg_kw(False, "off", 1, 1, False))
    _, sat = tops.noisy_mvm(torch.from_numpy(w), torch.from_numpy(x),
                            prng.key(3), cfg)
    assert sat.any() and not sat.all()


@pytest.mark.parametrize("r0,total", [(0, 10), (4, 10), (7, 10)])
def test_noisy_read_row_offset(r0, total):
    """A chunk read at row_offset draws the full batch's noise rows: it
    agrees with the matching rows of the port's full read and with the JAX
    package's chunk read."""
    cfg_kw = dict(read_noise=SIGMA, out_bound=ALPHA, use_pallas=True,
                  max_array_cols=20)
    w, _ = _data(11, 1, False)
    x = np.random.default_rng(12).standard_normal((total, K)).astype(
        np.float32)
    wt = torch.from_numpy(w)
    full, fsat = tops.noisy_mvm(wt, torch.from_numpy(x), prng.key(5),
                                TCfg(**cfg_kw))
    xc = x[r0:r0 + 3]
    y, sat = tops.noisy_mvm(wt, torch.from_numpy(xc), prng.key(5),
                            TCfg(**cfg_kw), row_offset=r0, total_rows=total)
    np.testing.assert_array_equal(sat.numpy(), fsat.numpy()[r0:r0 + 3])
    np.testing.assert_allclose(y.numpy(), full.numpy()[r0:r0 + 3], rtol=0,
                               atol=RTOL * float(full.abs().max()))
    yj, satj = jops.noisy_mvm(jax.numpy.asarray(w), jax.numpy.asarray(xc),
                              jax.random.key(5), JCfg(**cfg_kw),
                              row_offset=r0, total_rows=total)
    np.testing.assert_array_equal(sat.numpy(), np.asarray(satj))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0,
                               atol=RTOL * float(np.abs(yj).max()))


def test_managed_rejects_iterative_bm():
    cfg = TCfg(**_cfg_kw(True, "iterative", 1, 1, False))
    w, x = _data(1, 1, False)
    with pytest.raises(ValueError, match="iterative BM"):
        tops.managed_mvm(torch.from_numpy(w), torch.from_numpy(x),
                         prng.key(0), cfg)


def test_launch_counters_untouched_on_cpu():
    """The plain versions run for CPU tensors and launch nothing."""
    tops.reset_launch_counts()
    w, x = _data(2, 1, False)
    cfg = TCfg(**_cfg_kw(True, "two_phase", 1, 1, False))
    tops.managed_mvm(torch.from_numpy(w), torch.from_numpy(x), prng.key(0),
                     cfg)
    tops.noisy_mvm(torch.from_numpy(w), torch.from_numpy(x), prng.key(0),
                   cfg)
    assert tops.launch_counts() == {
        "noisy_read": 0, "managed_read": 0, "managed_read_conv": 0,
        "pulse_counts": 0, "pulse_update": 0, "bwd_update": 0,
        "bwd_update_conv": 0, "flash_attention": 0, "key_schedule": 0}


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


KERNEL_CASES = [
    # (B, rows, cols, n_seg, transpose, d_avg, row_offset)
    (4, 96, 80, 1, False, 1, 0),
    (130, 200, 300, 3, False, 1, 0),
    (5, 80, 96, 2, True, 1, 0),
    (70, 39, 100, 1, False, 3, 0),
    (6, 64, 64, 1, False, 1, 9),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_cuda_kernels_match_plain(case, cuda):
    b, r, c, n_seg, tr, d, off = case
    g = torch.Generator().manual_seed(b * r + c)
    w = (torch.randn(r, c, generator=g) * 0.3).to(cuda)
    x = (torch.randn(b, r if tr else c, generator=g) * 1.5).to(cuda)
    nm = torch.rand(b, 1, generator=g).add_(0.5).to(cuda)
    kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=n_seg, transpose=tr,
              row_offset=off, total_rows=b + off)
    y, sat = tnoisy.noisy_mvm(w, x, 123, **kw)
    yp, satp = tnoisy.noisy_mvm_plain(w, x, 123, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sat, satp)
    torch.testing.assert_close(y, yp, rtol=0, atol=1e-4)
    y, res = tmanaged.managed_mvm(w, x, nm, (5, 6), two_phase=True,
                                  retry_scale=16.0, d_avg=d, **kw)
    yp, resp = tmanaged.managed_mvm_plain(w, x, nm, (5, 6), two_phase=True,
                                          retry_scale=16.0, d_avg=d, **kw)
    torch.cuda.synchronize()
    assert torch.equal(res, resp)
    torch.testing.assert_close(y, yp, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# The managed read's launch plan (host side, runs here) and its CUDA paths
# ---------------------------------------------------------------------------

PLANS = [
    # (B, k_dim, out_phys, transpose, aligned[, n_seg])
    #     -> (path, tile_m, tile_n, ncw, vec)
    ((4, 4096, 11008, False, True), ("gemv", 0, 0, 2, True)),  # deepseek wi
    ((4, 11008, 4096, False, True), ("gemv", 0, 0, 2, True)),  # wo, 3 segs
    ((2, 5120, 1024, False, True), ("gemv", 0, 0, 1, True)),   # qwen3 k/v
    ((2, 5120, 151936, False, True), ("gemv", 0, 0, 2, True)),  # unembed
    ((8, 513, 128, False, True), ("gemv", 0, 0, 1, False)),    # LeNet W3
    ((8, 4096, 4096, False, False), ("gemv", 0, 0, 2, False)),  # unaligned
    ((9, 4096, 4096, False, True), ("tile", 64, 128, 0, True)),  # B > 8
    ((128, 4096, 11008, False, True), ("tile", 64, 128, 0, True)),
    ((2000, 5120, 17408, False, True), ("tile", 128, 128, 0, True)),
    ((2000, 5120, 5120, False, True), ("tile", 128, 128, 0, True)),
    ((2000, 5120, 1024, False, True), ("tile", 64, 128, 0, True)),
    ((2000, 5120, 1024, False, True, 2), ("tile", 128, 128, 0, True)),
    ((300, 4096, 4096, False, True), ("tile", 64, 128, 0, True)),
    ((300, 4096, 4096, False, True, 2), ("tile", 128, 128, 0, True)),
    ((4, 4096, 4096, True, True), ("tile", 64, 128, 0, True)),   # transpose
    ((8, 128, 513, True, True), ("tile", 64, 128, 0, False)),    # W3^T
    ((4608, 16, 26, True, True), ("tile", 64, 128, 0, False)),   # K1^T
    ((512, 401, 32, False, True), ("tile", 64, 128, 0, False)),  # K2 cols
]


@pytest.mark.parametrize("args,want", PLANS, ids=str)
def test_managed_read_plan(args, want):
    assert tuple(tmanaged.plan(*args)) == want


def test_plan_fills_the_card_or_takes_the_smaller_tile():
    """The tiled path takes 128x128 tiles where they give every SM a block
    (a block per tile and segment), else 64x128; decode reads never take
    the tiled path."""
    for b, out, n_seg in itertools.product(
            (9, 64, 128, 512, 2000, 4608), (26, 1024, 4096, 11008, 17408),
            (1, 3)):
        p = tmanaged.plan(b, 4096, out, False, True, n_seg)
        blocks = {t: -(-b // t[0]) * -(-out // t[1]) * n_seg
                  for t in tmanaged.TILES}
        fits = [t for t in tmanaged.TILES if blocks[t] >= tmanaged.SMS]
        assert p.path == "tile"
        assert (p.tile_m, p.tile_n) == (fits[0] if fits
                                        else tmanaged.TILES[-1])
    for b in range(1, tmanaged.GEMV_MAXB + 1):
        assert tmanaged.plan(b, 4096, 4096, False).path == "gemv"


RAW_PLANS = [
    # (B, k_dim, out_dim, transpose, aligned[, n_seg])
    #     -> (path, tile_m, tile_n, ncw, vec, split)
    ((4, 4096, 11008, False, True), ("gemv", 0, 0, 2, True, 1)),  # wi
    ((4, 11008, 4096, False, True, 3), ("gemv", 0, 0, 2, True, 1)),  # wo
    ((4, 4096, 102400, False, True), ("gemv", 0, 0, 2, True, 1)),  # unembed
    ((1, 4096, 1024, False, True), ("gemv", 0, 0, 1, True, 1)),
    ((8, 513, 128, False, True), ("gemv", 0, 0, 1, False, 1)),    # LeNet W3
    ((8, 4096, 4096, False, False), ("gemv", 0, 0, 2, False, 1)),  # unaligned
    # deepseek's prefill B = 128: 64 and 172 tiles balanced by splits
    ((128, 4096, 4096, False, True), ("tile", 64, 128, 0, True, 4)),
    ((128, 4096, 11008, False, True), ("tile", 64, 128, 0, True, 2)),
    ((128, 11008, 4096, False, True, 3), ("tile", 64, 128, 0, True, 2)),
    ((128, 11008, 4096, True, True, 3), ("tile", 64, 128, 0, True, 2)),
    ((4, 4096, 4096, True, True), ("tile", 64, 128, 0, True, 7)),  # transpose
    ((300, 520, 200, True, True, 2), ("tile", 32, 32, 0, True, 2)),
    ((130, 300, 200, False, True, 3), ("tile", 32, 32, 0, True, 1)),
    ((2000, 5120, 17408, False, True, 2), ("tile", 128, 128, 0, True, 1)),
    # LeNet's ITERATIVE reads: unaligned rows, short contractions (4x4
    # outputs per thread in 32x32 tiles)
    ((4608, 26, 16, False, True), ("tile", 32, 32, 0, False, 1)),   # K1
    ((512, 401, 32, False, True), ("tile", 32, 32, 0, False, 3)),   # K2
    ((4608, 16, 26, True, True), ("tile", 32, 32, 0, False, 1)),    # K1^T
    ((512, 32, 401, True, True), ("tile", 32, 32, 0, False, 1)),    # K2^T
    ((8, 128, 513, True, True), ("tile", 32, 32, 0, False, 1)),     # W3^T
    ((8, 10, 129, True, True), ("tile", 32, 32, 0, False, 1)),      # W4^T
]


@pytest.mark.parametrize("args,want", RAW_PLANS, ids=str)
def test_raw_read_plan(args, want):
    assert tuple(tnoisy.plan(*args)) == want


def test_raw_read_split_balances_the_grid():
    """The raw read takes the managed read's gemv and tile shape (SHORT_TILE
    for segments shorter than SHORT_SEG), and splits each segment's
    contraction into the fewest parts that give the card SPLIT_TARGET
    blocks, unless MAX_SPLIT or the least part depth (MIN_SPLIT_DEPTH) caps
    them; decode reads never split."""
    for b, k, out, n_seg in itertools.product(
            (1, 8, 9, 128, 512, 4608), (26, 401, 4096, 11008),
            (16, 401, 4096, 11008), (1, 3)):
        p = tnoisy.plan(b, k, out, False, True, n_seg)
        m = tmanaged.plan(b, k, out, False, True, n_seg)
        seg = -(-k // n_seg)
        if p.path == "gemv" or seg >= tnoisy.SHORT_SEG:
            assert (p.path, p.tile_m, p.tile_n, p.ncw, p.vec) == tuple(m)
        else:
            assert (p.path, p.tile_m, p.tile_n) == ("tile",
                                                     *tnoisy.SHORT_TILE)
        if p.path == "gemv":
            assert p.split == 1
            continue
        blocks = -(-b // p.tile_m) * -(-out // p.tile_n) * n_seg
        cap = max(1, min(tnoisy.MAX_SPLIT, seg // tnoisy.MIN_SPLIT_DEPTH))
        assert 1 <= p.split <= cap
        assert p.split == cap or blocks * p.split >= tnoisy.SPLIT_TARGET
        assert p.split == 1 or blocks * (p.split - 1) < tnoisy.SPLIT_TARGET


def _scaled(g, rows, cols, dev):
    """Rows at scales 1, 8 and 300 in turn: no saturation, the first read
    only, and both two-phase reads (alpha 12)."""
    v = torch.randn(rows, cols, generator=g)
    s = torch.tensor([1.0, 8.0, 300.0])[torch.arange(rows) % 3][:, None]
    return (v * s).contiguous().to(dev)


def _managed_pair(w, x, nm_on, seeds, **kw):
    nm = (x.abs().amax(1, keepdim=True) if nm_on
          else torch.ones(x.shape[0], 1, device=x.device))
    kw = dict(sigma=SIGMA, alpha=12.0, two_phase=True, retry_scale=16.0,
              **kw)
    got = tmanaged.managed_mvm(w, x, nm, seeds, **kw)
    want = tmanaged.managed_mvm_plain(w, x, nm, seeds, **kw)
    torch.cuda.synchronize()
    return got, want


def _assert_read_close(got, want, w, x, transpose):
    """Within 1e-5 of the largest sum |x||w| (f32 reassociation), flags
    equal."""
    mag = float((x.abs() @ (w.abs() if transpose else w.abs().T)).max())
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * max(1.0, mag)


MANAGED_CUDA_CASES = [
    # (B, rows, cols, n_seg, transpose, d_avg): LeNet's unaligned rows
    (8, 16, 26, 1, False, 1), (8, 32, 401, 1, False, 1),
    (8, 128, 513, 1, False, 1), (8, 10, 129, 1, False, 1),
    (4608, 16, 26, 1, True, 1), (512, 32, 401, 1, True, 1),
    (8, 128, 513, 1, True, 1), (96, 416, 401, 1, False, 13),
    # seg_len 3670 (wo in 3 segments), decode and a partial 64-row tile
    (4, 200, 11008, 3, False, 1), (70, 200, 11008, 3, False, 1),
    # partial tiles: 64 x 128 (130 = 2*64 + 2 rows) and 128 x 128
    # (600 = 4*128 + 88; 2000 = 15*128 + 80)
    (130, 200, 300, 2, False, 1), (600, 4096, 64, 1, False, 1),
    (2000, 2200, 64, 1, False, 1), (300, 520, 200, 2, True, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("nm_on", [False, True])
@pytest.mark.parametrize("case", MANAGED_CUDA_CASES, ids=str)
def test_cuda_managed_paths_match_plain(case, nm_on, cuda):
    b, r, c, n_seg, tr, d = case
    g = torch.Generator().manual_seed(b + r + c)
    w = (torch.randn(r, c, generator=g) * (r if tr else c) ** -0.5).to(cuda)
    x = _scaled(g, b, r if tr else c, cuda)
    got, want = _managed_pair(w, x, nm_on, (3, 2 ** 32 - 7), n_seg=n_seg,
                              transpose=tr, d_avg=d)
    _assert_read_close(got, want, w, x, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 9))
def test_cuda_gemv_every_batch(b, cuda):
    """Every decode batch 1-8 through the one-launch gemv, with and without
    float4 loads (a 4-aligned and an unaligned row length)."""
    for c in (4096, 4093):
        g = torch.Generator().manual_seed(b * c)
        w = (torch.randn(300, c, generator=g) * c ** -0.5).to(cuda)
        x = _scaled(g, b, c, cuda)
        assert tmanaged.plan(b, c, 300, False).path == "gemv"
        for nm_on in (False, True):
            got, want = _managed_pair(w, x, nm_on, (b, 9), n_seg=2)
            _assert_read_close(got, want, w, x, False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 4096), (200, 512, 4096)],
                         ids=["gemv", "tile"])
def test_cuda_flags_do_not_leak_between_reads(shape, cuda):
    """A read whose rows saturate on both reads, then one that saturates
    nowhere, on one stream: the second read's flags are its own, and the
    scratch is zero after each read."""
    b, r, c = shape
    g = torch.Generator().manual_seed(11)
    w = (torch.randn(r, c, generator=g) * c ** -0.5).to(cuda)
    loud = (torch.randn(b, c, generator=g) * 300.0).to(cuda)
    quiet = (torch.randn(b, c, generator=g) * 0.1).to(cuda)
    for x, sat in ((loud, True), (quiet, False), (loud, True)):
        got, want = _managed_pair(w, x, False, (1, 2))
        assert bool(got[1].all()) == sat and torch.equal(got[1], want[1])
        _assert_read_close(got, want, w, x, False)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        flags, _ = tgemm._SCRATCH[(w.device, stream)]
        assert int(flags.abs().sum()) == 0


def _raw_pair(w, x, seed, **kw):
    kw = dict(sigma=SIGMA, alpha=12.0, **kw)
    got = tnoisy.noisy_mvm(w, x, seed, **kw)
    want = tnoisy.noisy_mvm_plain(w, x, seed, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 9))
def test_cuda_raw_gemv_every_batch(b, cuda):
    """Every decode batch 1-8 of the raw read through its one-launch gemv,
    with and without float4 loads, in one segment and in two."""
    for c in (4096, 4093):
        g = torch.Generator().manual_seed(b * c + 1)
        w = (torch.randn(300, c, generator=g) * c ** -0.5).to(cuda)
        x = _scaled(g, b, c, cuda)
        assert tnoisy.plan(b, c, 300, False).path == "gemv"
        for n_seg in (1, 2):
            got, want = _raw_pair(w, x, b + 40, n_seg=n_seg)
            _assert_read_close(got, want, w, x, False)


RAW_CUDA_CASES = [
    # (B, rows, cols, n_seg, transpose): LeNet's ITERATIVE reads, the
    # split tile (B 128), segments as planes with and without splits
    (4608, 16, 26, 1, False), (512, 32, 401, 1, False),
    (4608, 16, 26, 1, True), (512, 32, 401, 1, True),
    (8, 128, 513, 1, True), (8, 10, 129, 1, True),
    (128, 1024, 4096, 1, False), (130, 200, 300, 3, False),
    (70, 200, 11008, 3, False), (300, 520, 200, 2, True),
    (4, 512, 4096, 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAW_CUDA_CASES, ids=str)
def test_cuda_raw_tile_paths_match_plain(case, cuda):
    b, r, c, n_seg, tr = case
    g = torch.Generator().manual_seed(b + r + c + 7)
    w = (torch.randn(r, c, generator=g) * (r if tr else c) ** -0.5).to(cuda)
    x = _scaled(g, b, r if tr else c, cuda)
    got, want = _raw_pair(w, x, 2 ** 32 - 3, n_seg=n_seg, transpose=tr,
                          row_offset=5, total_rows=b + 9)
    _assert_read_close(got, want, w, x, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 4096), (200, 512, 4096),
                                   (128, 1024, 4096)],
                         ids=["gemv", "tile", "split"])
def test_cuda_raw_flags_do_not_leak_between_reads(shape, cuda):
    """Raw reads that saturate everywhere, nowhere, then everywhere on one
    stream: each read's flags are its own, and the scratch is zero after
    each read."""
    b, r, c = shape
    g = torch.Generator().manual_seed(12)
    w = (torch.randn(r, c, generator=g) * c ** -0.5).to(cuda)
    loud = (torch.randn(b, c, generator=g) * 300.0).to(cuda)
    quiet = (torch.randn(b, c, generator=g) * 0.1).to(cuda)
    for x, sat in ((loud, True), (quiet, False), (loud, True)):
        got, want = _raw_pair(w, x, 3)
        assert bool(got[1].all()) == sat and torch.equal(got[1], want[1])
        _assert_read_close(got, want, w, x, False)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        flags, _ = tgemm._SCRATCH[(w.device, stream)]
        assert int(flags.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 4096, 1), (4, 512, 4096, 2),
                                   (128, 1024, 4096, 1),
                                   (130, 200, 300, 3)],
                         ids=["gemv", "gemv-2seg", "split", "planes"])
def test_cuda_raw_read_is_one_launch(shape, cuda):
    """One raw read is one ordinary kernel launch: ten reads make ten
    ``cudaLaunchKernel`` calls and no other launch or memset, and every
    kernel record the profiler keeps is the raw read's (no fill before it,
    no flag conversion after it)."""
    b, r, c, n_seg = shape
    w = torch.randn(r, c, device=cuda)
    x = torch.randn(b, c, device=cuda)
    kw = dict(sigma=SIGMA, alpha=12.0, n_seg=n_seg)
    tnoisy.noisy_mvm(w, x, 1, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            tnoisy.noisy_mvm(w, x, 1, **kw)
        torch.cuda.synchronize()
    host, kernels = {}, {}
    for e in prof.key_averages():
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        (kernels if on_device else host)[e.key] = e.count
    launched = {k: n for k, n in host.items()
                if k.startswith(("cudaLaunch", "cudaMemset"))}
    assert launched == {"cudaLaunchKernel": 10}, launched
    assert kernels and all("raw_" in k for k in kernels), kernels
