"""Iterative bound management (the paper's halve-and-retry, Eq. 4) in the
port's two forms against each other and against the JAX package's
``with_bound_management`` (a ``lax.while_loop``).

The host loop (``management.with_bound_management``) decides each retry
on the host; the predicated form (``with_bound_management_predicated``)
unrolls every retry on a device predicate, so that a captured step can hold
it.  On the CPU the raw read is the plain version, which reads whatever
the predicate says: the predicated form must still equal the loop bit for
bit, and the JAX package's loop within RTOL of the largest |y| (the read
tolerance of test_torch_read.py: f32 reassociation and ulp-level
Box-Muller differences) with equal residual flags.

The tile is 32 x 65 at B = 4, in three cases: no vector saturates, the
retries clear every vector, and ``max_iters`` runs out with vectors still
saturated.  The CUDA cases (marked ``cuda``) hold kernel #1 with a device
seed and a predicate against its by-value launch and skip here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import management as jmgmt
from repro.core import tile as jtile
from repro.core.device import RPUConfig as JCfg
from repro_torch.core import management as tmgmt
from repro_torch.core import tile as ttile
from repro_torch.core.device import RPUConfig as TCfg
from repro_torch.kernels import key_schedule as tks
from repro_torch.kernels import noisy_mvm as tnoisy
from repro_torch.utils import fastrng, prng

RTOL = 1e-5
OUT_F, K, B = 32, 65, 4
# (case, nm, alpha, x scale, max_iters)
CASES = [("no_saturation", True, 12.0, 1.0, 10),
         ("retries_clear", False, 1.0, 4.0, 10),
         ("max_iters_out", True, 0.05, 1.0, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """With several pytest-xdist workers at once, torch's thread pool in
    each oversubscribes the cores (the iterative-BM engine tests took 162 s
    instead of 10 beside five busy workers), so this module's plain-version
    kernels run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(nm, alpha, scale, max_iters, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.3, 0.3, (OUT_F, K)).astype(np.float32)
    x = (scale * rng.uniform(-1, 1, (B, K))).astype(np.float32)
    kw = dict(noise_management=nm, nm_forward=nm, bound_management=True,
              bm_mode="iterative", bm_max_iters=max_iters, out_bound=alpha)
    return w, x, TCfg(**kw), JCfg(**kw)


def _port(w, x, cfg, key, form):
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)

    def mvm(xx, kk, go=None):
        return ttile.analog_mvm_reference(wt, xx, kk, cfg)

    use_nm = cfg.noise_management
    s = tmgmt.nm_scale(xt) if use_nm else None
    return form(mvm, xt, key, cfg.bm_max_iters, init_scale=s)


@pytest.mark.parametrize("case,nm,alpha,scale,max_iters", CASES,
                         ids=[c[0] for c in CASES])
def test_predicated_equals_loop_and_jax(case, nm, alpha, scale, max_iters):
    w, x, tcfg, jcfg = _fixture(nm, alpha, scale, max_iters)
    key = prng.key(11)
    y_loop, sat_loop = _port(w, x, tcfg, key, tmgmt.with_bound_management)
    with tmgmt.count_retries("cpu") as n:
        y_pred, sat_pred = _port(w, x, tcfg, key,
                                 tmgmt.with_bound_management_predicated)
    assert torch.equal(y_pred, y_loop) and torch.equal(sat_pred, sat_loop)

    # the case is what its name says
    retries = int(n)
    if case == "no_saturation":
        assert retries == 0 and not sat_loop.any()
    elif case == "retries_clear":
        assert 0 < retries < max_iters and not sat_loop.any()
    else:
        assert retries == max_iters and sat_loop.any()

    y_j, sat_j = jmgmt.with_management(
        lambda xx, kk: jtile.analog_mvm_reference(jnp.asarray(w), xx, kk,
                                                  jcfg),
        jnp.asarray(x), jax.random.key(11), jcfg, backward=False)
    y_j = np.asarray(y_j)
    np.testing.assert_allclose(y_loop.numpy(), y_j, rtol=0,
                               atol=RTOL * np.abs(y_j).max())
    np.testing.assert_array_equal(sat_loop.numpy(), np.asarray(sat_j))


def test_with_management_picks_the_form_by_key():
    """A host key takes the loop, a key tape's key the predicated form; the
    tape records every retry's key, and the plain key schedule then gives
    the loop's numbers."""
    w, x, tcfg, _ = _fixture(False, 1.0, 4.0, 10)
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    calls = []

    def mvm(xx, kk, go=None):
        calls.append(go)
        return ttile.analog_mvm_reference(wt, xx, kk, tcfg)

    y_host, sat_host = tmgmt.with_management(mvm, xt, prng.key(4), tcfg,
                                             backward=False)
    n_host = len(calls)
    assert all(go is None for go in calls) and 1 < n_host < 11
    calls.clear()
    tape = prng.KeyTape("cpu")
    y_dev, sat_dev = tmgmt.with_management(mvm, xt, tape.begin(), tcfg,
                                           backward=False)
    tape.end()
    assert len(calls) == 11 and calls[0] is None
    assert all(go.dtype == torch.bool and go.dim() == 0 for go in calls[1:])
    # the tape's seed table was empty while the step ran: fill it from a
    # root whose fold_in gives the host key, and run the step again
    base, ctr = prng.key(9), 3
    tks.key_schedule(tape, torch.tensor(base), torch.tensor(ctr))
    calls.clear()
    root = tape.begin()
    y_dev, sat_dev = tmgmt.with_management(mvm, xt, root, tcfg,
                                           backward=False)
    tape.end()
    y_host, sat_host = tmgmt.with_management(
        mvm, xt, prng.fold_in(base, ctr), tcfg, backward=False)
    assert torch.equal(y_dev, y_host) and torch.equal(sat_dev, sat_host)
    # 2 derivations per read (the split), seeds of the 11 reads
    assert len(tape.recorded[0]) == 2 * 11 and len(tape.recorded[2]) == 11


def test_plain_read_takes_a_device_seed_and_a_predicate():
    """The wrapper's plain version: a 0-d seed tensor reads as its int, and
    a predicate leaves the read as it is (the plain version reads all the
    same)."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((OUT_F, K)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    kw = dict(sigma=0.06, alpha=3.0)
    want = tnoisy.noisy_mvm(w, x, 12345, **kw)
    for go in (None, torch.tensor(True), torch.tensor(False)):
        got = tnoisy.noisy_mvm(w, x, torch.tensor(12345), go=go, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Kernel #1 with a device seed and a predicate (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, rows, cols, transpose, n_seg): decode gemv, LeNet's tiled reads
KERNEL_SHAPES = [(4, 4096, 4096, False, 1), (4608, 16, 26, False, 1),
                 (512, 32, 401, True, 1), (8, 128, 513, False, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_cuda_device_seed_matches_by_value(cuda, shape):
    b, r, c, transpose, n_seg = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(r, c, generator=g, device=cuda)
    x = torch.randn(b, r if transpose else c, generator=g, device=cuda)
    kw = dict(sigma=0.06, alpha=8.0, n_seg=n_seg, transpose=transpose)
    seed = fastrng.key_to_seed(prng.key(7))
    want = tnoisy.noisy_mvm(w, x, seed, **kw)
    got = tnoisy.noisy_mvm(w, x, torch.tensor(seed, device=cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_cuda_predicate_skips_the_read(cuda, shape):
    """``go`` true reads as no predicate; ``go`` false writes nothing and
    leaves the scratch zeroed (the next read is unchanged)."""
    b, r, c, transpose, n_seg = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn(r, c, generator=g, device=cuda)
    x = torch.randn(b, r if transpose else c, generator=g, device=cuda)
    kw = dict(sigma=0.06, alpha=8.0, n_seg=n_seg, transpose=transpose)
    want = tnoisy.noisy_mvm(w, x, 5, **kw)
    on = tnoisy.noisy_mvm(w, x, 5, go=torch.tensor(True, device=cuda), **kw)
    y_off, _ = tnoisy.noisy_mvm(w, x, 5, go=torch.tensor(False, device=cuda),
                                **kw)
    y_off.fill_(7.0)
    after = tnoisy.noisy_mvm(w, x, 5, **kw)
    torch.cuda.synchronize()
    for got in (on, after):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case,nm,alpha,scale,max_iters", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_predicated_equals_loop(cuda, case, nm, alpha, scale,
                                     max_iters):
    w, x, tcfg, _ = _fixture(nm, alpha, scale, max_iters)
    cfg = dataclasses.replace(tcfg, use_pallas=True)
    wt, xt = torch.from_numpy(w).to(cuda), torch.from_numpy(x).to(cuda)

    def mvm(xx, kk, go=None):
        return ttile.analog_mvm(wt, xx, kk, cfg, go=go)

    s = tmgmt.nm_scale(xt) if nm else None
    loop = tmgmt.with_bound_management(mvm, xt, prng.key(3), max_iters,
                                       init_scale=s)
    pred = tmgmt.with_bound_management_predicated(
        mvm, xt, prng.key(3), max_iters, init_scale=s)
    torch.cuda.synchronize()
    assert torch.equal(pred[0], loop[0]) and torch.equal(pred[1], loop[1])
