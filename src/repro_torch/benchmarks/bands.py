"""The statistical tier of the parity contract: the port's figure runs held
to the JAX package's seed bands.

``jax_bands.json`` (beside this module) holds the JAX package's
``cnn.train`` results at ``cnn_suite.BAND_PROTOCOL`` for every run of
``cnn_suite.PAIRS``, over the seeds ``cnn_suite.BAND_SEEDS``: per run its
``_describe`` config, the protocol, each seed's test errors and
``mean_last5``, and the JAX and numpy versions that made it.  The file is
written by ``python tests/test_torch_figures.py --write-bands`` from the
unedited JAX package (the test file's ``__main__``, the one place that
imports it).

The rule, decided per pair ``(a, b)`` from each run's ``mean_last5`` over
the seeds:

* band: the port's seed mean of a run lies in ``[min_j - delta, max_j +
  delta]``, ``min_j``/``max_j`` the JAX seeds' extremes and ``delta =
  max(std_j, MIN_DELTA)`` (``std_j``: numpy's population std over the JAX
  seeds; ``MIN_DELTA`` one percentage point);
* order: where the JAX means of ``a`` and ``b`` differ by at least the
  pair's delta (the larger of the two runs'), the port's means are in the
  same order; where they differ by less, the port's two means lie within
  that delta of each other.

The recurrent sequel's figure (``benchmarks/lstm_management.py``) is held
by the same rule: ``jax_lstm_bands.json`` holds the JAX package's three
copy-task curves at the figure's protocol over ``LSTM_SEEDS``, each seed's
``mean_last5`` the error ``1 - accuracy`` averaged over the last five
epochs (:func:`mean_last5_error`), and :data:`LSTM_PAIRS` are its pairs.
It is written by ``python tests/test_torch_lstm_figure.py --write-bands``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.benchmarks import cnn_suite

PATH = Path(__file__).resolve().parent / "jax_bands.json"
LSTM_PATH = PATH.with_name("jax_lstm_bands.json")
#: The least half-width of a band, in test error (one percentage point).
MIN_DELTA = 0.01
LSTM_SEEDS = (0, 1, 2)
#: (a, b): FP against managed, managed against unmanaged (1806.00166)
LSTM_PAIRS = (("fp_digital", "nm_bm_managed"),
              ("nm_bm_managed", "unmanaged_baseline"))


def mean_last5_error(accuracies: Sequence[float]) -> float:
    """A copy-task curve's band value: ``1 - accuracy`` averaged over its
    last five epochs."""
    return float(np.mean([1.0 - a for a in accuracies[-5:]]))


def load(path: Path = PATH) -> Dict:
    """The committed bands: ``{"runs": {name: entry}, ...}``."""
    with open(path) as f:
        return json.load(f)


def band(entry: Dict) -> Dict[str, float]:
    """A run's band from its JAX entry: ``{"mean", "lo", "hi", "delta"}``."""
    m = np.asarray([entry["mean_last5"][str(s)]
                    for s in sorted(int(k) for k in entry["mean_last5"])])
    delta = max(float(np.std(m)), MIN_DELTA)
    return {"mean": float(np.mean(m)), "lo": float(m.min()) - delta,
            "hi": float(m.max()) + delta, "delta": delta}


def decide(pair: Sequence[str], port: Dict[str, Sequence[float]],
           bands: Dict) -> Dict:
    """The verdict of one pair: ``port`` maps each run to its
    ``mean_last5`` per seed."""
    a, b = pair
    ba, bb = (band(bands["runs"][n]) for n in pair)
    pa, pb = (float(np.mean(port[n])) for n in pair)
    delta = max(ba["delta"], bb["delta"])
    in_a = ba["lo"] <= pa <= ba["hi"]
    in_b = bb["lo"] <= pb <= bb["hi"]
    jax_gap = bb["mean"] - ba["mean"]
    if abs(jax_gap) >= delta:
        order = "a<b" if jax_gap > 0 else "a>b"
        order_ok = (pb - pa) * jax_gap > 0
    else:
        order = "tie"
        order_ok = abs(pb - pa) < delta
    return {"pair": [a, b], "port": [pa, pb],
            "jax": [ba["mean"], bb["mean"]],
            "band_a": [ba["lo"], ba["hi"]], "band_b": [bb["lo"], bb["hi"]],
            "delta": delta, "in_band": [in_a, in_b], "order": order,
            "order_ok": order_ok, "ok": in_a and in_b and order_ok}


def decide_all(port: Dict[str, Sequence[float]], bands: Dict,
               pairs: Sequence[Sequence[str]] = cnn_suite.PAIRS
               ) -> List[Dict]:
    """The verdicts of every pair whose two runs ``port`` holds."""
    return [decide(p, port, bands) for p in pairs
            if p[0] in port and p[1] in port]


def describe(v: Dict) -> str:
    """One line of a verdict, errors in %."""
    pct = lambda x: f"{100 * x:.2f}"  # noqa: E731
    (a, b), (pa, pb), (ja, jb) = v["pair"], v["port"], v["jax"]
    return (f"{a} {pct(pa)} in [{pct(v['band_a'][0])}, "
            f"{pct(v['band_a'][1])}]: {v['in_band'][0]}; {b} {pct(pb)} in "
            f"[{pct(v['band_b'][0])}, {pct(v['band_b'][1])}]: "
            f"{v['in_band'][1]}; JAX means {pct(ja)} / {pct(jb)} "
            f"(order {v['order']}, delta {pct(v['delta'])}): "
            f"{v['order_ok']} -> {'PASS' if v['ok'] else 'FAIL'}")
