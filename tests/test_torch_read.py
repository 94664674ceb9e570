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
    assert tops.launch_counts() == {"noisy_read": 0, "managed_read": 0}


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
