"""Parity of the port's fused pulse update with the JAX package.

``ops.pulse_update_fused`` (on the CPU the plain version of the
``pulse_update`` kernel) against JAX's ``ops.pulse_update_fused`` (its
Pallas kernel in interpret mode) and against the port's
``ref.pulse_update_ref``, over the ``PULSE_CASES`` of
``tests/test_kernels.py``.  Device maps come from the JAX package's
``sample_device_maps``, weights and signed streams from a numpy seed.
Counts are exact integers on every side; the maps' products, the ctoc
normal (log, cos, sqrt) and XLA's fused multiply-adds differ by ulps, so
outputs agree within JAX's own test tolerance (rtol 1e-5, atol 1e-6).
Every output lies within +-bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import device as jdev
from repro.kernels import ops as jops
from repro_torch.core import device as tdev
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pulse_update as tpulse
from repro_torch.kernels import ref as tref
from repro_torch.utils import prng

PULSE_CASES = [
    # (m, n, batch, bl, ctoc) of tests/test_kernels.py
    (16, 26, 8, 10, 0.3),
    (32, 401, 16, 1, 0.3),
    (128, 513, 4, 10, 0.0),
    (130, 260, 64, 2, 0.3),    # non-128-aligned
    (10, 129, 1, 40, 0.3),     # single sample, long stream
]
KEY = 77


def _case(m, n, b, bl, ctoc, seed, *, fire=0.6, w_scale=0.1):
    """Maps, weights and signed streams ``(b, bl, m)`` / ``(b, bl, n)``
    (each entry fires with probability ``fire``, at a random sign)."""
    jcfg = jdev.RPUConfig(bl=bl, dw_min_ctoc=ctoc, use_pallas=True)
    jmaps = jdev.sample_device_maps(jax.random.key(3), m, n, jcfg)
    maps = [np.array(a) for a in (jmaps.dw_up, jmaps.dw_dn, jmaps.bound)]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, n)) * w_scale).astype(np.float32)

    def streams(k):
        on = rng.random((b, bl, k)) < fire
        sign = np.where(rng.random((b, bl, k)) < 0.5, -1.0, 1.0)
        return (on * sign).astype(np.float32)

    return jcfg, maps, w, streams(m), streams(n)


def _port(jcfg, maps, w, rows, cols):
    t = torch.from_numpy
    tcfg = tdev.RPUConfig(bl=jcfg.bl, dw_min_ctoc=jcfg.dw_min_ctoc,
                          use_pallas=True)
    tmaps = tdev.DeviceMaps(*(t(a) for a in maps))
    return tops.pulse_update_fused(t(w), tmaps, t(rows), t(cols),
                                   prng.key(KEY), tcfg)


@pytest.mark.parametrize("m,n,b,bl,ctoc", PULSE_CASES)
def test_fused_update_matches_jax_kernel(m, n, b, bl, ctoc):
    jcfg, maps, w, rows, cols = _case(m, n, b, bl, ctoc, seed=m + n)
    want = jops.pulse_update_fused(
        jnp.asarray(w), jdev.DeviceMaps(*(jnp.asarray(a) for a in maps)),
        jnp.asarray(rows), jnp.asarray(cols), jax.random.key(KEY), jcfg)
    before = tops.launch_counts()["pulse_update"]
    got = _port(jcfg, maps, w, rows, cols)
    assert tops.launch_counts()["pulse_update"] == before   # plain on CPU
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got.abs() <= torch.from_numpy(maps[2])).all()


@pytest.mark.parametrize("m,n,b,bl,ctoc", PULSE_CASES)
def test_fused_update_matches_reference(m, n, b, bl, ctoc):
    jcfg, maps, w, rows, cols = _case(m, n, b, bl, ctoc, seed=m * n)
    got = _port(jcfg, maps, w, rows, cols)
    t = torch.from_numpy
    want = tref.pulse_update_ref(t(w), *(t(a) for a in maps), t(rows),
                                 t(cols), prng.key(KEY), ctoc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    if ctoc == 0.0:
        # no noise: the same products and sums, in the same order
        assert torch.equal(got, want)


def test_fused_update_clips_to_bound():
    """Long all-firing streams of one sign drive every device past its
    bound: the update clips each to +-bound, and the clip binds."""
    jcfg, maps, w, _, _ = _case(32, 48, 1, 10, 0.3, seed=5)
    rows = np.ones((1024, 10, 32), np.float32)
    cols = np.ones((1024, 10, 48), np.float32)
    cols[:, :, ::2] = -1.0
    got = _port(jcfg, maps, w, rows, cols)
    bound = torch.from_numpy(maps[2])
    assert (got.abs() <= bound).all()
    assert (got.abs() == bound).float().mean() > 0.9


def test_fused_update_rejects_mismatched_streams():
    jcfg, maps, w, rows, cols = _case(16, 26, 8, 10, 0.3, seed=1)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="do not fit"):
        tpulse.pulse_update(t(w), *(t(a) for a in maps),
                            t(rows).reshape(-1, 16)[:, :15],
                            t(cols).reshape(-1, 26), 1, ctoc=0.3)


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,b,bl,ctoc", PULSE_CASES + [
    (416, 401, 512, 1, 0.3)])                  # LeNet's K2, #_d 13
def test_cuda_fused_update_matches_plain(m, n, b, bl, ctoc, cuda):
    _, maps, w, rows, cols = _case(m, n, b, bl, ctoc, seed=9)
    t = lambda a: torch.from_numpy(a).reshape(-1, a.shape[-1])
    args = [t(w)] + [t(a) for a in maps] + [t(rows), t(cols)]
    want = tpulse.pulse_update_plain(*args, 0xC0FFEE, ctoc)
    got = tpulse.pulse_update(*(a.to(cuda) for a in args), 0xC0FFEE,
                              ctoc=ctoc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
