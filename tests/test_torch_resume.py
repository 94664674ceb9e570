"""Kill-and-resume of the port's LeNet trainer on the CPU, and the fault
injector (``repro_torch.distributed.fault``).

A run SIGKILLed at an epoch boundary (``REPRO_FAULT_MODE=sigkill``) and
restarted resumes from its newest complete checkpoint and must end on the
bytes of the run that was never interrupted: the final checkpoint's
per-leaf ``(key, shape, dtype, crc32)`` from the store's own index, and its
history.  The runs are subprocesses (SIGKILL cannot be caught), at the
sizes of the JAX package's ``tests/test_resume_parity.py``: 3 epochs,
batch 8, 64 training images analog or 96 digital, 32 test images.  Each
mode's oracle runs once, under ``engine="python"``, so a run killed and
resumed under ``engine="scan"`` is also held to the loop's bits across
processes.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from repro_torch.checkpoint import store
from repro_torch.distributed import fault
from repro_torch.distributed.fault import DeviceLossError, FaultInjector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240


def _run(body: str, *, env=None, expect_sigkill=False):
    e = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="2")
    # never inherit a fault configuration from the caller
    for k in ("REPRO_FAULT_MODE", "REPRO_FAULT_STEP", "REPRO_FAULT_DROP",
              "REPRO_CKPT_WRITE_DELAY"):
        e.pop(k, None)
    e.update({k: str(v) for k, v in (env or {}).items()})
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                         capture_output=True, text=True, env=e,
                         timeout=RUN_TIMEOUT_S)
    if expect_sigkill:
        assert res.returncode == -signal.SIGKILL, (
            res.returncode, res.stdout[-2000:], res.stderr[-2000:])
    else:
        assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-4000:])
    return res


def _fingerprint(ckpt_dir, step: int):
    """Per-leaf (key, shape, dtype, crc32) from the store's index, and the
    saved metadata."""
    with open(os.path.join(ckpt_dir, f"step_{step:010d}",
                           "index.json")) as f:
        idx = json.load(f)
    return ([(e["key"], tuple(e["shape"]), e["dtype"], e["crc32"])
             for e in idx["leaves"]], idx["meta"])


_CNN_BODY = """
    from repro_torch.analog import presets
    from repro_torch.models import lenet
    from repro_torch.train import cnn

    if {analog!r}:
        cfg = lenet.LeNetConfig.from_policy(
            presets.parse_policy("K2=rpu_baseline,*=managed"))
    else:
        cfg = lenet.LeNetConfig(mode="digital")
    cnn.train(cfg, epochs=3, batch=8, n_train={n_train}, n_test=32,
              seed=0, verbose=True, engine={engine!r},
              ckpt_dir={ckpt_dir!r}, device="cpu")
    print("RUN_DONE")
"""


def _cnn_body(analog, engine, ckpt_dir):
    return _CNN_BODY.format(analog=analog, engine=engine,
                            ckpt_dir=str(ckpt_dir),
                            n_train=64 if analog else 96)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The uninterrupted run's directory for a mode (one run per mode)."""
    dirs = {}

    def get(analog):
        if analog not in dirs:
            d = tmp_path_factory.mktemp(f"oracle_{int(analog)}")
            _run(_cnn_body(analog, "python", d))
            assert store.latest_step(str(d)) == 3
            dirs[analog] = d
        return dirs[analog]

    return get


@pytest.mark.parametrize("analog", [False, True],
                         ids=["digital", "analog_policy"])
@pytest.mark.parametrize("engine", ["scan", "python"])
def test_cnn_kill_resume_bitexact(tmp_path, oracle, analog, engine):
    want = _fingerprint(oracle(analog), 3)
    # killed at the top of epoch 2, just after step 2's async save began:
    # step 1 is complete, step 2 complete or torn
    _run(_cnn_body(analog, engine, tmp_path),
         env={"REPRO_FAULT_MODE": "sigkill", "REPRO_FAULT_STEP": 2},
         expect_sigkill=True)
    latest = store.latest_step(str(tmp_path))
    assert latest in (1, 2), latest

    res = _run(_cnn_body(analog, engine, tmp_path))
    assert f"resumed after epoch {latest}" in res.stdout
    leaves, meta = _fingerprint(tmp_path, 3)
    assert leaves == want[0]
    assert meta["history"] == want[1]["history"]
    assert len(meta["history"]) == 3


def test_cnn_kill_mid_save_falls_back(tmp_path, oracle):
    """Killed while step 2's write is held open (0.2 s a leaf): step 2 is
    torn, the resume starts after epoch 1 and ends on the oracle's bytes,
    and no partial is left."""
    want = _fingerprint(oracle(False), 3)
    _run(_cnn_body(False, "scan", tmp_path),
         env={"REPRO_FAULT_MODE": "sigkill_mid_save",
              "REPRO_FAULT_STEP": 1, "REPRO_CKPT_WRITE_DELAY": 0.2},
         expect_sigkill=True)
    assert store.latest_step(str(tmp_path)) == 1
    assert os.path.isdir(tmp_path / "step_0000000002.tmp")

    res = _run(_cnn_body(False, "scan", tmp_path))
    assert "resumed after epoch 1" in res.stdout
    assert _fingerprint(tmp_path, 3) == want
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_cnn_resume_of_a_finished_run_trains_nothing(tmp_path, oracle,
                                                     capsys):
    """A run restarted after its last epoch restores, trains no epoch and
    returns the saved history."""
    from repro_torch.models import lenet
    from repro_torch.train import cnn
    d = oracle(False)
    want = _fingerprint(d, 3)
    r = cnn.train(lenet.LeNetConfig(mode="digital"), epochs=3, batch=8,
                  n_train=96, n_test=32, seed=0, ckpt_dir=str(d),
                  device="cpu")
    assert "[cnn] resumed after epoch 3" in capsys.readouterr().out
    assert r["test_error"] == want[1]["history"]
    assert _fingerprint(d, 3) == want


# --- fault injector (the JAX package's tests/test_fault.py) ----------------

def test_fault_injector_device_loss_fires_once_at_step():
    inj = FaultInjector("device_loss", fault_step=3, drop=2)
    inj.check(0)
    inj.check(2)                          # before the boundary: no-op
    with pytest.raises(DeviceLossError) as ei:
        inj.check(3)
    assert ei.value.n_lost == 2
    inj.check(5)                          # fires once, then inert


def test_fault_injector_mid_save_requires_saving_flag():
    inj = FaultInjector("sigkill_mid_save", fault_step=1)
    inj.check(5, saving=False)            # would SIGKILL if it fired
    assert not inj.fired


def test_fault_injector_rejects_unknown_mode():
    with pytest.raises(ValueError):
        FaultInjector("power_surge", 0)


def test_fault_injector_from_env_is_singleton(monkeypatch):
    monkeypatch.setattr(fault, "_ENV_INJECTOR", None)
    monkeypatch.delenv("REPRO_FAULT_MODE", raising=False)
    assert FaultInjector.from_env() is None
    monkeypatch.setenv("REPRO_FAULT_MODE", "device_loss")
    monkeypatch.setenv("REPRO_FAULT_STEP", "4")
    monkeypatch.setenv("REPRO_FAULT_DROP", "3")
    inj = FaultInjector.from_env()
    assert (inj.mode, inj.fault_step, inj.drop) == ("device_loss", 4, 3)
    # an in-process restart re-reading the environment gets the same
    # (fired) injector: one configured fault per process
    assert FaultInjector.from_env() is inj
    monkeypatch.setattr(fault, "_ENV_INJECTOR", None)


def test_fault_injector_device_loss_drains_the_writer_first():
    """``device_loss`` waits for the in-flight write before raising, and a
    failed write does not hide the loss."""
    class Writer:
        waited = 0

        def wait(self):
            Writer.waited += 1
            raise OSError("disk full")

    inj = FaultInjector("device_loss", fault_step=0)
    with pytest.raises(DeviceLossError):
        inj.check(0, flush=Writer())
    assert Writer.waited == 1
