"""The port's epoch engine (``repro_torch.train.engine``) and its device key
schedule against the host key schedule, the per-step loop and the JAX
package's engine, on the CPU (the engine runs uncaptured there, through
the plain versions of the kernels and of the key schedule).

The LeNet is the paper's full width (K1 16x26, K2 32x401 or 416x401, W3
128x513, W4 10x129) at a few images and steps.  Every comparison is
bitwise: keys and seeds are integers, and both engines run the same
operations on the same batches under the same seeds.  The CUDA cases
(marked ``cuda``) need the card and skip here; ``chip_smoke.py`` phase g2
holds the captured graph against the loop there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import lenet as jlenet
from repro.train import engine as jengine
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.core import update
from repro_torch.data import synthetic_mnist as tdata
from repro_torch.kernels import key_schedule as tks
from repro_torch.models import lenet as tlenet
from repro_torch.train import cnn as tcnn
from repro_torch.train import engine as tengine
from repro_torch.utils import fastrng, prng

FUSED = "managed:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
SEPARATE = "managed:use_pallas=true:bm_mode=two_phase"
PAPER = ("K2=k2_multi_device:use_pallas=true:bm_mode=two_phase"
         ":fuse_bwd_update=true,*=" + FUSED)
POLICIES = pytest.mark.parametrize("policy", [FUSED, SEPARATE, PAPER],
                                   ids=["fused", "separate", "paper"])
M32 = 0xFFFFFFFF


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


def _cfg(policy):
    return tlenet.LeNetConfig.from_policy(tpresets.parse_policy(policy))


def _images(n, seed=1):
    x, y = tdata.make_dataset(n, seed=seed)
    return torch.from_numpy(x), torch.from_numpy(y)


def _logged_seeds(monkeypatch):
    """Every key handed to ``fastrng.key_to_seed``, in call order."""
    log = []
    orig = fastrng.key_to_seed

    def logged(key):
        log.append(key)
        return orig(key)

    monkeypatch.setattr(fastrng, "key_to_seed", logged)
    return log


@POLICIES
def test_tape_matches_the_host_schedule(policy, monkeypatch):
    """One step's tape, evaluated by the plain key schedule, gives every
    key and seed the host route derives, in the order the step asks for
    them; the filled seed table holds the same words."""
    cfg = _cfg(policy)
    x, y = _images(2)
    k_train, counter = prng.key(6), 41
    step = tengine.make_cnn_step_fn(cfg)
    log = _logged_seeds(monkeypatch)
    step(tlenet.init(prng.key(0), cfg), x, y, prng.fold_in(k_train, counter))
    host = list(log)
    log.clear()
    tape = prng.KeyTape("cpu")
    step(tlenet.init(prng.key(0), cfg), x, y, tape.begin())
    tape.end()
    device = list(log)
    assert len(host) == len(device) > 20
    assert all(isinstance(k, prng.DeviceKey) for k in device)

    keys, seeds = tks.evaluate_plain(tape, k_train, counter)
    assert [keys[k.slot] for k in device] == host
    slots = tape.recorded[2]
    want = [fastrng.key_to_seed(k) for k in host]
    assert [seeds[slots.index(k.slot)] for k in device] == want
    tks.key_schedule(tape, torch.tensor(k_train), torch.tensor(counter))
    assert [int(tape.seeds[slots.index(k.slot)]) for k in device] == want
    assert tape.keys[:len(keys)].tolist() == [list(k) for k in keys]


def test_tape_refuses_a_changed_tree():
    tape = prng.KeyTape("cpu")
    prng.split(tape.begin(), 3)
    tape.end()
    prng.split(tape.begin(), 2)
    with pytest.raises(RuntimeError, match="key tree changed"):
        tape.end()


def test_tape_holds_what_the_kernel_can():
    """A tape takes as many keys as its tables hold (TAPE_SLOTS, the root
    included) and refuses one more."""
    tape = prng.KeyTape("cpu")
    root = tape.begin()
    for i in range(prng.TAPE_SLOTS - 1):
        prng.fold_in(root, i)
    assert len(tape.parent) + 1 == tape.keys.shape[0] == prng.TAPE_SLOTS
    with pytest.raises(RuntimeError, match="key tape full"):
        prng.fold_in(root, prng.TAPE_SLOTS)


@pytest.mark.parametrize("seed", [0, 2025])
def test_fold_in_keys_matches_jax(seed):
    got = tengine.fold_in_keys(prng.key(seed), np.arange(0, 300))
    want = jax.random.key_data(
        jengine.fold_in_keys(jax.random.key(seed), jnp.arange(0, 300)))
    np.testing.assert_array_equal(got, np.asarray(want))


@POLICIES
def test_run_epoch_matches_the_python_engine(policy):
    """``train(engine="scan")`` (the epoch engine, uncaptured on the CPU)
    and ``train(engine="python")`` leave every tile bitwise equal and
    report the same test errors."""
    cfg = _cfg(policy)
    kw = dict(epochs=1, batch=8, n_train=24, n_test=20, device="cpu",
              verbose=False, return_params=True)
    scan = tcnn.train(cfg, engine="scan", **kw)
    loop = tcnn.train(cfg, engine="python", **kw)
    assert scan["engine"] == "scan" and loop["engine"] == "python"
    assert scan["test_error"] == loop["test_error"]
    for name in tlenet.LAYERS:
        assert torch.equal(scan["params"][name].w, loop["params"][name].w)


def test_run_epoch_keeps_the_python_schedule_across_epochs():
    """Two epochs of one ``run_epoch`` (one recording, counters reset per
    epoch) equal two epochs of the loop."""
    cfg = _cfg(FUSED)
    xs, ys = _images(16)
    k_data, k_train = prng.key(3), prng.key(2)
    a, b = (tlenet.init(prng.key(0), cfg) for _ in range(2))
    step = tcnn.make_train_step(cfg)
    run = tengine.make_cnn_epoch_fn(cfg, batch=8)
    for epoch in (0, 1):
        tcnn.python_epoch(step, a, xs, ys, k_data, k_train, epoch, 8)
        run(b, xs, ys, k_data, k_train, epoch)
    for name in tlenet.LAYERS:
        assert torch.equal(a[name].w, b[name].w)
    assert run.program.ctr.tolist() == [2, 4]


# the paper's iterative BM; at alpha = 1 the first steps' reads saturate
# and retry (at alpha = 12 none does)
ITERATIVE = "nm_bm:use_pallas=true"
ITERATIVE_A1 = ITERATIVE + ":out_bound=1"


@pytest.mark.parametrize("policy", [ITERATIVE, ITERATIVE_A1],
                         ids=["alpha12", "alpha1"])
def test_scan_matches_python_under_iterative_bm(policy):
    """Three steps and an evaluation through the epoch engine (the
    predicated retries, their keys on the tape) leave every tile bitwise
    equal to the per-step loop's (the host loop) and report the same
    error; at alpha = 1 retries run.  Evaluation batches of 8 keep the
    plain reads small."""
    from repro_torch.core import management
    cfg = _cfg(policy)
    xs, ys = _images(24)
    k_data, k_train, k_eval = prng.key(3), prng.key(2), prng.key(4)
    loop, scan = (tlenet.init(prng.key(0), cfg) for _ in range(2))
    tcnn.python_epoch(tcnn.make_train_step(cfg), loop, xs, ys, k_data,
                      k_train, 0, 8)
    with management.count_retries("cpu") as n:
        tengine.make_cnn_epoch_fn(cfg, batch=8)(scan, xs, ys, k_data,
                                                k_train, 0)
        err = tengine.make_cnn_eval_fn(cfg, batch=8)(scan, xs[:8], ys[:8],
                                                     k_eval)
    for name in tlenet.LAYERS:
        assert torch.equal(scan[name].w, loop[name].w)
    assert err == tcnn.make_eval(cfg, batch=8)(loop, xs[:8], ys[:8], k_eval)
    assert (int(n) > 0) == (policy == ITERATIVE_A1)


def test_iterative_step_fits_the_tape():
    """An ITERATIVE step records every retry's key: 11 reads' splits for
    each of its 8 reads, well inside TAPE_SLOTS."""
    cfg = _cfg(ITERATIVE)
    x, y = _images(2)
    tape = prng.KeyTape("cpu")
    tengine.make_cnn_step_fn(cfg)(tlenet.init(prng.key(0), cfg), x, y,
                                  tape.begin())
    tape.end()
    parent, _, seeds = tape.recorded
    assert len(seeds) == 8 * 11 + 4 * 3      # reads, update streams
    assert len(parent) + 1 < prng.TAPE_SLOTS


@pytest.mark.parametrize("policy", [FUSED, PAPER], ids=["fused", "paper"])
def test_eval_fn_matches_make_eval(policy):
    """Analog evaluation on a split that is no batch multiple: the padded
    graph-per-batch evaluation and the loop report the same error."""
    cfg = _cfg(policy)
    params = tlenet.init(prng.key(1), cfg)
    xs, ys = _images(21)
    evaluate = tengine.make_cnn_eval_fn(cfg, batch=8)
    for key in (prng.key(4), prng.key(9)):
        assert evaluate(params, xs, ys, key) == tcnn.make_eval(
            cfg, batch=8)(params, xs, ys, key)


def test_eval_fn_matches_jax_digital():
    """Digital evaluation against the JAX package's ``make_cnn_eval_fn`` on
    the same parameters and a split that is no batch multiple: the same
    count of correct images."""
    jcfg = jlenet.LeNetConfig(mode="digital")
    pj = jlenet.init(jax.random.key(3), jcfg)
    tree = {n: {"w": np.asarray(s.w),
                "seed": np.asarray(jax.random.key_data(s.seed)),
                "meta": s.meta} for n, s in pj.items()}
    pt = from_jax_params(tree, device="cpu")
    x, y = tdata.make_dataset(37, seed=2)
    err_j = float(jengine.make_cnn_eval_fn(jcfg, batch=16)(
        pj, jnp.asarray(x), jnp.asarray(y), jax.random.key(0)))
    err_t = tengine.make_cnn_eval_fn(tlenet.LeNetConfig(mode="digital"),
                                     batch=16)(
        pt, torch.from_numpy(x), torch.from_numpy(y), prng.key(0))
    assert round((1.0 - err_t) * 37) == round((1.0 - err_j) * 37)
    assert 0 < round((1.0 - err_t) * 37) < 37


@pytest.mark.parametrize("seed", [0, 7, M32])
def test_seeded_ops_take_a_device_seed(seed):
    """The digital ops that take a u32 seed give the same bits from a 0-d
    int64 tensor as from the int."""
    t = torch.tensor(seed, dtype=torch.int64)
    assert torch.equal(fastrng.bits_from_seed(seed, (3, 5), 11),
                       fastrng.bits_from_seed(t, (3, 5), 11))
    e = torch.arange(40, dtype=torch.int64)
    assert torch.equal(fastrng.normal_at(fastrng.mix_int(seed), e, 40),
                       fastrng.normal_at(fastrng.mix_seed(t), e, 40))
    g = torch.Generator().manual_seed(seed & 0xFFFF)
    v = torch.randn(4, 9, generator=g)
    gain = torch.tensor(0.7)
    assert torch.equal(update.signed_streams(seed, v, gain, 3, row_offset=2),
                       update.signed_streams(t, v, gain, 3, row_offset=2))
    up, dn = torch.randint(0, 4, (2, 5, 6), generator=g).float()
    maps = torch.rand(2, 5, 6, generator=g) * 1e-3
    assert torch.equal(update.counts_to_dw(up, dn, *maps, seed, 0.3),
                       update.counts_to_dw(up, dn, *maps, t, 0.3))


# ---------------------------------------------------------------------------
# The captured engine and the key-schedule kernel (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_key_schedule_matches_plain(cuda):
    cfg = _cfg(FUSED)
    x, y = _images(2)
    tape = prng.KeyTape(cuda)
    tengine.make_cnn_step_fn(cfg)(tlenet.init(prng.key(0), cfg, device=cuda),
                                  x.to(cuda), y.to(cuda), tape.begin())
    tape.end()
    base = torch.tensor(prng.key(6), device=cuda)
    for counter in (0, 5, 2 ** 32 + 3):
        tks.key_schedule(tape, base, torch.tensor(counter, device=cuda))
        keys, seeds = tks.evaluate_plain(tape, prng.key(6), counter)
        assert tape.keys[:len(keys)].tolist() == [list(k) for k in keys]
        assert tape.seeds[:len(seeds)].tolist() == seeds


@pytest.mark.cuda
@POLICIES
def test_cuda_graphed_epoch_matches_loop(policy, cuda):
    cfg = _cfg(policy)
    xs, ys = (t.to(cuda) for t in _images(32))
    a, b = (tlenet.init(prng.key(0), cfg, device=cuda) for _ in range(2))
    tcnn.python_epoch(tcnn.make_train_step(cfg), a, xs, ys, prng.key(3),
                      prng.key(2), 0, 8)
    tengine.make_cnn_epoch_fn(cfg, batch=8)(b, xs, ys, prng.key(3),
                                            prng.key(2), 0)
    torch.cuda.synchronize()
    for name in tlenet.LAYERS:
        assert torch.equal(a[name].w, b[name].w)
