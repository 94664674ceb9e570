"""The port's LM trainer on the CPU at the deepseek_7b smoke size (2
layers, d 64, vocab 256; batch 2, seq 32): the engine runs uncaptured
there, through the plain versions of the kernels and of the key schedule.

* remat on is bitwise remat off (the recompute re-derives the same keys);
* ``engine="scan"`` (``train/engine.py``'s ``scan_steps``) is bitwise
  ``engine="python"`` over 3 steps: params, optimizer state and losses,
  digital (AdamW) and under two policies (iterative BM with AdamW on the
  digital leaves; bare ``--analog``, two-phase BM on the fused route);
* a run checkpointed at step 2 and resumed is bitwise the uninterrupted 4
  steps, and so is a run restarted after a simulated device loss;
* the fault-tolerance pieces behave as the JAX package's;
* the CLI trains on the CPU.

The CUDA case (marked ``cuda``) needs the card and skips here;
``chip_smoke.py`` phase t holds the captured graph against the loop at
full width there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analog.convert import stack_layers
from repro_torch.checkpoint import store
from repro_torch.distributed import fault as tfault
from repro_torch.launch import train as ttrain
from repro_torch.train import lm as tlm
from repro_torch.utils import prng

B, S = 2, 32
ITERATIVE = "lm_managed:use_pallas=true"
FUSED = "lm_managed:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return [(k, v) for k, v in store._flatten_with_paths(stack_layers(tree))]


def assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert type(x) is type(y), k


def _run(**kw):
    args = dict(steps=3, batch=B, seq=S, smoke=True, device="cpu",
                verbose=False, return_params=True)
    args.update(kw)
    return ttrain.train("deepseek_7b", **args)


@pytest.mark.parametrize("spec", [FUSED, ITERATIVE],
                         ids=["fused", "iterative"])
def test_remat_changes_no_bit(spec):
    cfg = ttrain.lm_config("deepseek_7b", smoke=True, analog_policy=spec)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, S)).astype(np.int32))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        step, opt = tlm.make_train_step(c)
        params, state = tlm.init_train_state(0, c, opt, device="cpu")
        params, state, m = step(params, state, {"tokens": toks},
                                prng.key(4))
        out.append(((params, state), m["loss"]))
    assert torch.equal(out[0][1], out[1][1])
    assert_bitwise(out[0][0], out[1][0])


@pytest.mark.parametrize("kw", [dict(), dict(analog_policy=ITERATIVE),
                                dict(analog=True, use_pallas=True,
                                     bm_mode="two_phase",
                                     fuse_bwd_update=True)],
                         ids=["digital", "iterative", "legacy_fused"])
def test_scan_engine_is_the_loop_bitwise(kw):
    scan = _run(engine="scan", scan_chunk=2, **kw)
    loop = _run(engine="python", **kw)
    assert scan["losses"] == loop["losses"] and len(scan["losses"]) == 3
    assert scan["engine"] == "scan" and scan["device"] == "cpu"
    assert_bitwise((scan["params"], scan["opt_state"]),
                   (loop["params"], loop["opt_state"]))
    if not kw:
        assert int(scan["opt_state"]["count"]) == 3


def test_resume_and_restart_are_bitwise_the_uninterrupted_run(
        tmp_path, monkeypatch):
    kw = dict(analog_policy=ITERATIVE, steps=4, ckpt_every=2)
    full = _run(**kw)
    d = str(tmp_path / "a")
    _run(**dict(kw, steps=2), ckpt_dir=d)
    assert store.latest_step(d) == 2
    resumed = _run(ckpt_dir=d, **kw)
    assert resumed["losses"] == full["losses"][2:]    # steps 2 and 3
    assert_bitwise((resumed["params"], resumed["opt_state"]),
                   (full["params"], full["opt_state"]))

    # a device loss at the step-3 boundary: one restart from step 2
    monkeypatch.setattr(ttrain.FaultInjector, "from_env", classmethod(
        lambda cls, _i=tfault.FaultInjector("device_loss", 3): _i))
    restarted = _run(ckpt_dir=str(tmp_path / "b"), max_restarts=1,
                     engine="python", **kw)
    assert restarted["losses"] == full["losses"]
    assert_bitwise((restarted["params"], restarted["opt_state"]),
                   (full["params"], full["opt_state"]))


def test_fault_pieces_match_jax():
    jfault = pytest.importorskip("repro.distributed.fault")
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 6.0, 6.0, 1.2]
    a, b = tfault.StragglerWatchdog(trip_after=2), jfault.StragglerWatchdog(
        trip_after=2)
    for i, t in enumerate(times):
        ra, rb = a.observe(i, t), b.observe(i, t)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    a.reset()
    assert a.ewma is None
    h = tfault.PreemptionHandler().install()
    assert not h.preemption_requested()
    h.simulate()
    assert h.preemption_requested()
    calls = []

    def run(state):
        calls.append(state)
        if len(calls) < 3:
            raise tfault.DeviceLossError(1)

    assert tfault.run_with_restarts(lambda: len(calls), run,
                                    max_restarts=2) == 2

    def always(state):
        raise tfault.DeviceLossError(1)

    with pytest.raises(tfault.DeviceLossError):
        tfault.run_with_restarts(lambda: 0, always, max_restarts=0)


def test_cli_trains_deepseek_smoke_on_the_cpu(capsys):
    ttrain.main(["--arch", "deepseek_7b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--analog-policy",
                 "*attn*=managed,*mlp*=rpu_baseline", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] resolved analog policy" in out
    assert "unembed" in out and "fp (digital)" in out
    assert "[train deepseek_7b] step 1 loss" in out
    assert "on cpu, engine scan" in out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [FUSED, ITERATIVE],
                         ids=["fused", "iterative"])
def test_cuda_graphed_lm_steps_match_loop(spec, cuda):
    scan = _run(engine="scan", analog_policy=spec, device=cuda)
    loop = _run(engine="python", analog_policy=spec, device=cuda)
    torch.cuda.synchronize()
    assert scan["losses"] == loop["losses"]
    assert_bitwise((scan["params"], scan["opt_state"]),
                   (loop["params"], loop["opt_state"]))
