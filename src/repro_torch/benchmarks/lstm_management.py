"""The recurrent sequel's headline comparison on the port (Gokmen, Rasch &
Haensch 2018, "Training LSTM Networks with Resistive Cross-Point Devices",
arXiv:1806.00166): the same RPU tiles re-read every timestep, managed (NM
+ fixed-latency BM per-timestep read) against unmanaged (Table 1 verbatim)
on the delayed-copy task, beside the FP reference.

Port of the JAX package's ``benchmarks/figures.py`` ``LSTM_CURVES``,
``run_lstm_management`` and ``report_lstm_management``.  The paper's
qualitative result must reproduce: management keeps the recurrent training
converging while the unmanaged baseline stalls (the verdict: at every seed
the managed curve ends at least 0.1 above the unmanaged one and 0.1 above
its own first epoch).  The statistical tier holds each curve to the JAX
package's seed band (``bands.py``: ``jax_lstm_bands.json``, the rule of
the CNN pairs on ``1 - accuracy`` over the last five epochs).

On a CUDA device every analog site runs on the kernels, as
``cnn_suite.on_kernels`` does: ``use_pallas``, plus ``fuse_bwd_update``
where BM is not iterative (:func:`on_kernels`).

  python -m repro_torch.benchmarks.lstm_management --seeds 0,1,2

writes the curves' JSON (``--out``) and prints the report; it exits 1 when
a band or the verdict fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.benchmarks import bands

LSTM_RESULTS = os.path.join("results", "bench", "lstm_management.json")

# (label, analog_policy spec) per curve; None = digital fp reference.
# The copy task's one-hot inputs keep recurrent MVM signals ~1/10 of the
# paper's LSTM workload, so (like the CNN suite's ``stress_a3`` runs) the
# saturation mechanism is surfaced at a compressed integrator bound
# (alpha=2): the unmanaged baseline's reads clip and training collapses,
# while per-timestep NM+BM rescales and retries around the same bound.
LSTM_CURVES = (
    ("fp_digital", None),
    ("nm_bm_managed", "nm_bm:bm_mode=two_phase:out_bound=2"),
    ("unmanaged_baseline", "rpu_baseline:out_bound=2"),
)
#: The figure's protocol (the JAX ``run_lstm_management`` defaults).
PROTOCOL = dict(epochs=12, batch=16, seq=4, lr=0.05, time_chunk=2)


def on_kernels(spec: Optional[str]) -> Optional[str]:
    """A one-preset ``spec`` with its site on the kernels: ``use_pallas``,
    and ``fuse_bwd_update`` where its BM is not iterative."""
    if spec is None:
        return None
    from repro_torch.analog.presets import resolve_spec
    from repro_torch.core import management
    fuse = not management.bm_is_iterative(resolve_spec(spec))
    return spec + ":use_pallas=true" + (":fuse_bwd_update=true" if fuse
                                        else "")


def run_lstm_management(epochs: int = 12, batch: int = 16, seq: int = 4,
                        lr: float = 0.05, time_chunk: int = 2, *,
                        seeds: Sequence[int] = (0,), device="cuda",
                        engine: str = "scan", verbose: bool = False) -> Dict:
    """Train the three curves at each seed; per-epoch copy-task accuracy
    under ``curves[label][seed]``, steps/s under ``steps_per_sec``."""
    import torch
    from repro_torch.launch.train import train_sequence

    kernels = torch.device(device).type == "cuda"
    out: Dict = {"protocol": {"task": "delayed copy", "arch": "lstm",
                              "seq_len": seq, "batch": batch, "lr": lr,
                              "epochs": epochs, "time_chunk": time_chunk},
                 "seeds": list(seeds), "device": str(torch.device(device)),
                 "engine": engine, "policies": {}, "curves": {},
                 "steps_per_sec": {}}
    for label, spec in LSTM_CURVES:
        pol = on_kernels(spec) if kernels else spec
        out["policies"][label] = pol
        for seed in seeds:
            res = train_sequence(
                "lstm", steps=epochs, batch=batch, seq=seq, smoke=False,
                analog=pol is not None, analog_policy=pol, lr=lr,
                time_chunk=time_chunk, seed=seed, device=device,
                engine=engine, verbose=verbose,
                log_every=max(1, epochs // 4))
            out["curves"].setdefault(label, {})[str(seed)] = \
                res["accuracies"]
            out["steps_per_sec"].setdefault(label, {})[str(seed)] = \
                res["steps_per_sec"]
    return out


def verdict(res: Dict) -> Dict[str, Dict]:
    """The paper's verdict at each seed: managed ends at least 0.1 above
    unmanaged and 0.1 above its own first epoch."""
    out = {}
    for seed, managed in res["curves"]["nm_bm_managed"].items():
        unmanaged = res["curves"]["unmanaged_baseline"][seed]
        gap = managed[-1] - unmanaged[-1]
        out[seed] = {"managed": managed[-1], "unmanaged": unmanaged[-1],
                     "gap": gap,
                     "ok": gap >= 0.1 and managed[-1] > managed[0] + 0.1}
    return out


def band_verdicts(res: Dict, jax_bands: Optional[Dict] = None) -> List[Dict]:
    """Each pair of :data:`bands.LSTM_PAIRS` decided by the band rule on
    the curves' ``mean_last5`` errors."""
    if jax_bands is None:
        jax_bands = bands.load(bands.LSTM_PATH)
    port = {label: [bands.mean_last5_error(c) for c in curves.values()]
            for label, curves in res["curves"].items()}
    return bands.decide_all(port, jax_bands, bands.LSTM_PAIRS)


def report_lstm_management(res: Dict, jax_bands: Optional[Dict] = None
                           ) -> List[str]:
    """Accuracy curves, the band verdicts and the paper's verdict."""
    lines = ["=== LSTM MANAGEMENT (1806.00166) ===",
             f"  copy-task accuracy by epoch (protocol: {res['protocol']}, "
             f"{res['device']})"]
    for label, _ in LSTM_CURVES:
        for seed, curve in res["curves"].get(label, {}).items():
            pts = "  ".join(f"{a:.3f}" for a in curve)
            lines.append(f"  {label:<20} seed {seed}: {pts}")
    for v in band_verdicts(res, jax_bands):
        lines.append("  band: " + bands.describe(v))
    for seed, v in verdict(res).items():
        lines.append(f"  seed {seed} final: managed {v['managed']:.3f} vs "
                     f"unmanaged {v['unmanaged']:.3f} (gap {v['gap']:+.3f})"
                     f" -> {'PASS' if v['ok'] else 'FAIL'} (managed "
                     "converges, unmanaged stalls)")
    return lines


def passed(res: Dict, jax_bands: Optional[Dict] = None) -> bool:
    """Every band verdict and every seed's paper verdict holds."""
    return (all(v["ok"] for v in band_verdicts(res, jax_bands))
            and all(v["ok"] for v in verdict(res).values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=("scan", "python"), default="scan")
    ap.add_argument("--out", default=LSTM_RESULTS)
    args = ap.parse_args(argv)
    res = run_lstm_management(
        **PROTOCOL, seeds=[int(s) for s in args.seeds.split(",")],
        device=args.device, engine=args.engine)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("\n".join(report_lstm_management(res)))
    print(f"[lstm-mgmt] wrote {args.out}")
    return 0 if passed(res) else 1


if __name__ == "__main__":
    sys.exit(main())
