"""Beyond-paper validation: the RPU technique *trains* a transformer LM
(the JAX package's ``benchmarks/analog_lm_convergence.py``).

The paper closes by claiming the management techniques carry to networks
beyond convolutional or fully connected ones.  This trains the deepseek_7b
smoke model (same token stream) digitally (AdamW) and on analog RPU tiles
(bare ``--analog``: NM + BM + UM at BL 1 on the block projections, pure
pulse-SGD) for 150 steps at batch 4, seq 128, and reports each run's mean
loss over its first and last 10 steps (``first10``, ``last10``).

Pass rule, the JAX benchmark's: the analog run's loss drops substantially
(``a1 < 0.85 * a0``) at every seed.  Held to the JAX package's runs at the
same seeds (``jax_lm_bands.json``, written by ``python
tests/test_torch_lm_train.py --write-bands``) by the figures' band rule
(``bands.decide``, on ``last10``): each run's seed mean in its JAX band and
the two runs in JAX's order.  Both runs start from the JAX package's
initial weights of the seed (``init_lm(jax_weights=True)``), so port and
JAX train the same model on the same tokens under the same noise seeds
and differ by float rounding only.  On a card the analog reads and
updates run on the CUDA kernels (``use_pallas``), through the graphed
engine.

  python -m repro_torch.benchmarks.analog_lm_convergence --seeds 0,1,2
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import numpy as np

PROTOCOL = {"steps": 150, "batch": 4, "seq": 128, "smoke": True}
SEEDS = (0, 1, 2)
HEAD_TAIL = 10
MODES = ("digital", "analog")


def head_tail(losses: Sequence[float], k: int = HEAD_TAIL):
    return float(np.mean(losses[:k])), float(np.mean(losses[-k:]))


def run(seed: int, device="cuda", verbose: bool = False) -> Dict[str, List]:
    """Both runs of one seed: ``{"digital": losses, "analog": losses}``."""
    import torch
    from repro_torch.launch.train import train
    on_card = torch.device(device).type == "cuda"
    return {m: train("deepseek_7b", seed=seed, analog=m == "analog",
                     use_pallas=on_card and m == "analog", log_every=25,
                     device=device, verbose=verbose, jax_weights=True,
                     **PROTOCOL)["losses"]
            for m in MODES}


def bands_document(runs: Dict[int, Dict[str, List]], **about) -> Dict:
    """Per mode: each seed's losses (every 5th), ``first10`` and
    ``last10``."""
    doc = {"protocol": PROTOCOL, "seeds": sorted(runs), **about, "runs": {}}
    for m in MODES:
        entry = {"losses": {}, "first10": {}, "last10": {}}
        for seed, r in runs.items():
            a0, a1 = head_tail(r[m])
            entry["losses"][str(seed)] = r[m][::5]
            entry["first10"][str(seed)] = a0
            entry["last10"][str(seed)] = a1
        doc["runs"][m] = entry
    return doc


def verdict(runs: Dict[int, Dict[str, List]], bands_doc: Dict) -> Dict:
    """The JAX pass rule at every seed and the band verdict on
    ``last10``."""
    from repro_torch.benchmarks import bands
    learned = {}
    for seed, r in runs.items():
        a0, a1 = head_tail(r["analog"])
        learned[seed] = a1 < 0.85 * a0
    port = {m: [head_tail(r[m])[1] for r in runs.values()] for m in MODES}
    v = bands.decide(MODES, port, bands_doc, key="last10")
    return {"learned": learned, "band": v,
            "ok": all(learned.values()) and v["ok"]}


def main(argv=None):
    from repro_torch.benchmarks import bands
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runs = {int(s): run(int(s), args.device, verbose=True)
            for s in args.seeds.split(",")}
    v = verdict(runs, bands.load(bands.LM_PATH))
    for seed, r in runs.items():
        (d0, d1), (a0, a1) = (head_tail(r[m]) for m in MODES)
        print(f"[analog-lm] seed {seed}: digital {d0:.3f}->{d1:.3f} | "
              f"analog {a0:.3f}->{a1:.3f} (a1 < 0.85 a0: "
              f"{v['learned'][seed]})")
    print("[analog-lm] " + bands.describe(v["band"], percent=False))
    print(json.dumps({"ok": v["ok"]}))
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
