"""The recurrent sequel's figure (1806.00166) on the port against the JAX
package: the curve table and protocol, the committed seed bands
(``repro_torch/benchmarks/jax_lstm_bands.json``), the band rule and the
paper's verdict on made-up curves, and one short port run on the CPU.

The curves at the figure's protocol run on the card (``python -m
repro_torch.benchmarks.lstm_management``, chip_smoke phase l).  The JAX
bands are made once, outside pytest, by this file's own entry point::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lstm_figure.py \\
        --write-bands [--jobs 3]

which trains the JAX package's three curves at ``PROTOCOL`` over
``bands.LSTM_SEEDS`` (one process per curve and seed) and writes the JSON.
The file's test re-runs the JAX managed curve at seed 0 and finds its
accuracies in the file exactly (the same JAX program on the same inputs).
"""

import inspect
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.benchmarks import bands as tbands
from repro_torch.benchmarks import lstm_management as tfig

# the JAX package's benchmarks/ is a directory of the repository root
ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker (a full pool in each
    oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_curve(job):
    """One JAX ``train_sequence`` curve at the figure's protocol:
    ``(label, seed, accuracies)``."""
    from repro.launch.train import train_sequence
    label, spec, seed = job
    p = tfig.PROTOCOL
    r = train_sequence("lstm", steps=p["epochs"], batch=p["batch"],
                       seq=p["seq"], smoke=False, analog=spec is not None,
                       analog_policy=spec, lr=p["lr"],
                       time_chunk=p["time_chunk"], seed=seed,
                       log_every=10 ** 6)
    return label, seed, r["accuracies"]


def test_curves_and_protocol_match_jax():
    from benchmarks import figures as jfig
    assert tfig.LSTM_CURVES == jfig.LSTM_CURVES
    sig = inspect.signature(jfig.run_lstm_management).parameters
    assert tfig.PROTOCOL == {k: v.default for k, v in sig.items()}


def test_on_kernels_sets_the_flags():
    assert tfig.on_kernels(None) is None
    assert tfig.on_kernels("nm_bm:bm_mode=two_phase:out_bound=2") == (
        "nm_bm:bm_mode=two_phase:out_bound=2:use_pallas=true"
        ":fuse_bwd_update=true")
    # the paper's iterative BM keeps the separate route
    assert tfig.on_kernels("nm_bm") == "nm_bm:use_pallas=true"


def test_jax_lstm_bands_file_matches_a_run():
    """The file holds every curve at every band seed with its
    ``mean_last5``; the JAX managed curve at seed 0, trained again here,
    is in it to the bit."""
    data = tbands.load(tbands.LSTM_PATH)
    assert data["protocol"] == tfig.PROTOCOL
    assert data["seeds"] == list(tbands.LSTM_SEEDS)
    assert set(data["runs"]) == {label for label, _ in tfig.LSTM_CURVES}
    seeds = [str(s) for s in tbands.LSTM_SEEDS]
    for label, spec in tfig.LSTM_CURVES:
        entry = data["runs"][label]
        assert entry["spec"] == spec
        assert sorted(entry["accuracies"]) == sorted(entry["mean_last5"]) \
            == seeds
        for s in seeds:
            accs = entry["accuracies"][s]
            assert len(accs) == tfig.PROTOCOL["epochs"]
            assert entry["mean_last5"][s] == tbands.mean_last5_error(accs)
    label, spec = tfig.LSTM_CURVES[1]
    _, _, accs = _jax_curve((label, spec, 0))
    assert accs == data["runs"][label]["accuracies"]["0"]


def _made_up(curves):
    return {"curves": {label: {str(s): c for s, c in enumerate(cs)}
                       for label, cs in curves.items()}}


def test_band_rule_and_verdict_on_made_up_curves():
    flat = lambda a: [a] * 12  # noqa: E731
    jax_res = _made_up({"fp_digital": [flat(0.5), flat(0.55)],
                        "nm_bm_managed": [[0.1] + [0.3] * 11,
                                          [0.1] + [0.35] * 11],
                        "unmanaged_baseline": [flat(0.0), flat(0.0)]})
    jax_bands = {"runs": {
        label: {"mean_last5": {s: tbands.mean_last5_error(c)
                               for s, c in cs.items()}}
        for label, cs in jax_res["curves"].items()}}
    assert tbands.mean_last5_error([0.0] * 7 + [0.5] * 5) == 0.5
    assert tfig.passed(jax_res, jax_bands)
    # managed outside its band (and no longer 0.1 above its first epoch)
    low = _made_up({"fp_digital": [flat(0.5)],
                    "nm_bm_managed": [[0.1] + [0.15] * 11],
                    "unmanaged_baseline": [flat(0.0)]})
    vs = tfig.band_verdicts(low, jax_bands)
    assert [v["pair"] for v in vs] == [list(p) for p in tbands.LSTM_PAIRS]
    assert not all(v["ok"] for v in vs)
    assert not tfig.verdict(low)["0"]["ok"]
    assert not tfig.passed(low, jax_bands)
    # the verdict needs a gap of 0.1 at the last epoch
    close = _made_up({"nm_bm_managed": [[0.1] + [0.3] * 11],
                      "unmanaged_baseline": [[0.0] * 11 + [0.25]]})
    v = tfig.verdict(close)["0"]
    assert v["gap"] == pytest.approx(0.05) and not v["ok"]
    lines = tfig.report_lstm_management(
        dict(jax_res, protocol=tfig.PROTOCOL, device="cpu"), jax_bands)
    assert sum("PASS" in line for line in lines) == 4


def test_port_curves_run_on_the_cpu():
    """One short epoch of each curve through the port (plain versions on
    the CPU; batch 2, two payload symbols): the result's shape and an
    accuracy per curve."""
    p = dict(tfig.PROTOCOL, epochs=1, batch=2, seq=2, time_chunk=1)
    res = tfig.run_lstm_management(**p, seeds=(0,), device="cpu")
    assert res["policies"] == dict(tfig.LSTM_CURVES)
    for label, _ in tfig.LSTM_CURVES:
        (acc,) = res["curves"][label]["0"]
        assert 0.0 <= acc <= 1.0


def write_bands(jobs: int = 3) -> None:
    """Train the JAX package's three curves at every band seed and write
    jax_lstm_bands.json."""
    import multiprocessing
    work = [(label, spec, s) for label, spec in tfig.LSTM_CURVES
            for s in tbands.LSTM_SEEDS]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs) as pool:
        done = list(pool.imap_unordered(_jax_curve, work))
    for label, seed, accs in sorted(done):
        print(f"[bands] {label} seed {seed}: mean_last5 error "
              f"{tbands.mean_last5_error(accs):.4f}", flush=True)
    versions = {"jax": jax.__version__, "numpy": np.__version__}
    runs = {}
    for label, spec in tfig.LSTM_CURVES:
        mine = sorted((s, a) for n, s, a in done if n == label)
        runs[label] = {
            "spec": spec,
            "accuracies": {str(s): a for s, a in mine},
            "mean_last5": {str(s): tbands.mean_last5_error(a)
                           for s, a in mine},
        }
    with open(tbands.LSTM_PATH, "w") as f:
        json.dump({"protocol": dict(tfig.PROTOCOL),
                   "seeds": list(tbands.LSTM_SEEDS), "versions": versions,
                   "made_by": "python tests/test_torch_lstm_figure.py "
                              "--write-bands", "runs": runs}, f, indent=1)
    print(f"[bands] wrote {tbands.LSTM_PATH}")


if __name__ == "__main__":
    if "--write-bands" not in sys.argv:
        raise SystemExit("usage: test_torch_lstm_figure.py --write-bands "
                         "[--jobs N]")
    write_bands(int(sys.argv[sys.argv.index("--jobs") + 1])
                if "--jobs" in sys.argv else 3)
