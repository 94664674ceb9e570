"""The paper's named CNN runs (Figs. 3-6 and the bound-stress pair) on the
port, and the command line that trains them.

The same 26 runs as the JAX package's ``benchmarks/cnn_suite.py`` (which
imports ``repro``, so the port keeps its own table): each name maps to a
:class:`~repro_torch.models.lenet.LeNetConfig` built from the same presets
with the same per-layer replacements, and :data:`FIGURES` lists the runs of
each figure.  :data:`PAIRS` are the four comparisons that define the
figures' claims (management rescues training, UM with BL 1 beats BL 1
alone, BM rescues a saturating network, two-phase BM matches the paper's
iterative BM), :data:`EXTRA_RUNS` the one configuration they add (two-phase
BM).

Protocols: :data:`PROTOCOL` is the JAX package's compressed one (12 epochs
of 4096 synthetic images), :data:`PAPER_PROTOCOL` the paper's (real MNIST,
which the repository does not hold), :data:`BAND_PROTOCOL` the short one of
the seed bands (``jax_bands.json`` and ``bands.py`` beside this module).

    python -m repro_torch.benchmarks.cnn_suite --pairs --seeds 0,1,2 \\
        --protocol band --out results/torch_cnn
    python -m repro_torch.benchmarks.cnn_suite --figure fig4 \\
        --protocol compressed

writes one JSON per run and seed, ``<out>/<protocol>/<run>_seed<s>.json``
(the trainer's ``log_path`` payload plus the device and the kernel flags
each layer ran with), prints a table, and for ``--pairs`` at the band
protocol decides each pair against the JAX bands (exit 1 when one fails).
On a CUDA device every analog layer runs through the kernels
(``use_pallas``) and, where its bound management is not iterative, the
fused backward+update (``fuse_bwd_update``); the JAX package's numbers do
not depend on these flags.  Runs go through the epoch engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import device as dev
from repro_torch.core import management
from repro_torch.models.lenet import LAYERS, LeNetConfig

RESULTS_DIR = os.path.join("results", "torch_cnn")

# The JAX package's compressed protocol and the paper's.
PROTOCOL = dict(epochs=12, batch=8, n_train=4096, n_test=2048, seed=0)
PAPER_PROTOCOL = dict(epochs=30, batch=1, n_train=60000, n_test=10000,
                      seed=0)
# The seed bands' protocol: short enough that the JAX package's CPU run of
# a configuration takes about a minute (1536 steps).
BAND_PROTOCOL = dict(epochs=6, batch=8, n_train=2048, n_test=1024)
BAND_SEEDS = (0, 1, 2)
PROTOCOLS = {"band": BAND_PROTOCOL, "compressed": PROTOCOL,
             "paper": PAPER_PROTOCOL}

# The paper's reported test errors in % (the JAX package's
# benchmarks/figures.py), for the report beside the port's numbers.
PAPER = {
    "fp_baseline": 0.8, "fig3a_baseline": 15.0,
    "fig3a_no_noise_no_bound": 1.5, "fig3a_no_noise": 10.0,
    "fig3a_no_bound": 10.0, "fig3b_nm_only": 10.0, "fig3b_bm_only": 10.0,
    "fig3b_nm_bm": 1.7, "fig4_novar_all": 1.05, "fig4_novar_K1K2": 1.15,
    "fig4_novar_W3W4": 1.3, "fig4_novar_K1": 1.4, "fig4_novar_K2": 1.2,
    "fig4_dpw4_K2": 1.45, "fig4_dpw13_K2": 1.35, "fig5_bl1": 1.3,
    "fig5_bl40": 1.7, "fig5_bl1_um": 1.1, "fig5_bl10_um": 1.7,
    "fig6_full_dpw13_K2": 0.8, "stress_a3_no_noise": 10.0,
    "stress_a3_nm_bm": 1.7,
}


def _uniform(cfg, mode="analog"):
    return LeNetConfig.uniform(cfg, mode=mode)


def _runs() -> Dict[str, Callable[[], LeNetConfig]]:
    base = dev.rpu_baseline()
    nmbm = dev.rpu_nm_bm()
    um1 = dev.rpu_nm_bm_um_bl1()

    def no_bwd_noise(c):
        return dataclasses.replace(c, noise_backward=False)

    def inf_bound(c):
        return dataclasses.replace(c, out_bound=float("inf"))

    def no_var(c):
        return c.without_variations()

    def no_imb(c):
        return c.without_imbalance()

    def dpw(c, n):
        return dataclasses.replace(c, devices_per_weight=n)

    def bl(c, n, um=None):
        kw = dict(bl=n)
        if um is not None:
            kw["update_management"] = um
        return dataclasses.replace(c, **kw)

    def alpha(c, a):
        return dataclasses.replace(c, out_bound=a)

    R: Dict[str, Callable[[], LeNetConfig]] = {}
    R["fp_baseline"] = lambda: _uniform(base, mode="digital")
    # Fig. 3A: noise and bound ablations, no management
    R["fig3a_baseline"] = lambda: _uniform(base)
    R["fig3a_no_noise_no_bound"] = lambda: _uniform(
        no_bwd_noise(base)).replace_layer("W4", inf_bound(no_bwd_noise(base)))
    R["fig3a_no_noise"] = lambda: _uniform(no_bwd_noise(base))
    R["fig3a_no_bound"] = lambda: _uniform(base).replace_layer(
        "W4", inf_bound(base))
    # Fig. 3B: management ablations
    R["fig3b_nm_only"] = lambda: _uniform(
        base.with_management(nm=True, bm=False))
    R["fig3b_bm_only"] = lambda: _uniform(
        base.with_management(nm=False, bm=True))
    R["fig3b_nm_bm"] = lambda: _uniform(nmbm)
    # Fig. 4: device variations, per layer
    R["fig4_novar_all"] = lambda: _uniform(no_var(nmbm))
    R["fig4_novar_K1K2"] = lambda: (
        _uniform(nmbm).replace_layer("K1", no_var(nmbm))
        .replace_layer("K2", no_var(nmbm)))
    R["fig4_novar_W3W4"] = lambda: (
        _uniform(nmbm).replace_layer("W3", no_var(nmbm))
        .replace_layer("W4", no_var(nmbm)))
    R["fig4_novar_K1"] = lambda: _uniform(nmbm).replace_layer(
        "K1", no_var(nmbm))
    R["fig4_novar_K2"] = lambda: _uniform(nmbm).replace_layer(
        "K2", no_var(nmbm))
    R["fig4_noimb_all"] = lambda: _uniform(no_imb(nmbm))
    R["fig4_noimb_K1K2"] = lambda: (
        _uniform(nmbm).replace_layer("K1", no_imb(nmbm))
        .replace_layer("K2", no_imb(nmbm)))
    R["fig4_noimb_K2"] = lambda: _uniform(nmbm).replace_layer(
        "K2", no_imb(nmbm))
    R["fig4_dpw4_K2"] = lambda: _uniform(nmbm).replace_layer(
        "K2", dpw(nmbm, 4))
    R["fig4_dpw13_K2"] = lambda: _uniform(nmbm).replace_layer(
        "K2", dpw(nmbm, 13))
    # Fig. 5: update management and the BL sweep
    R["fig5_bl1"] = lambda: _uniform(bl(nmbm, 1))
    R["fig5_bl2"] = lambda: _uniform(bl(nmbm, 2))
    R["fig5_bl40"] = lambda: _uniform(bl(nmbm, 40))
    R["fig5_bl1_um"] = lambda: _uniform(um1)
    R["fig5_bl10_um"] = lambda: _uniform(bl(nmbm, 10, um=True))
    # Fig. 6: the full model
    R["fig6_full_dpw13_K2"] = lambda: _uniform(um1).replace_layer(
        "K2", dpw(um1, 13))
    # bound stress: the paper's bound failure surfaced at alpha = 3
    R["stress_a3_no_noise"] = lambda: _uniform(
        alpha(no_bwd_noise(base), 3.0))
    R["stress_a3_nm_bm"] = lambda: _uniform(alpha(nmbm, 3.0))
    return R


RUNS = _runs()

FIGURES = {
    "fig3a": ["fp_baseline", "fig3a_baseline", "fig3a_no_noise_no_bound",
              "fig3a_no_noise", "fig3a_no_bound"],
    "fig3b": ["fp_baseline", "fig3a_baseline", "fig3b_nm_only",
              "fig3b_bm_only", "fig3b_nm_bm"],
    "fig4": ["fp_baseline", "fig3b_nm_bm", "fig4_novar_all",
             "fig4_novar_K1K2", "fig4_novar_W3W4", "fig4_novar_K1",
             "fig4_novar_K2", "fig4_noimb_all", "fig4_noimb_K1K2",
             "fig4_noimb_K2", "fig4_dpw4_K2", "fig4_dpw13_K2"],
    "fig5": ["fp_baseline", "fig3b_nm_bm", "fig5_bl1", "fig5_bl2",
             "fig5_bl40", "fig5_bl1_um", "fig5_bl10_um"],
    "fig6": ["fp_baseline", "fig3a_baseline", "fig3b_nm_bm", "fig5_bl1_um",
             "fig6_full_dpw13_K2"],
    "stress": ["fp_baseline", "stress_a3_no_noise", "stress_a3_nm_bm"],
}

# the two-phase BM of benchmarks/bm_two_phase_check.py
EXTRA_RUNS: Dict[str, Callable[[], LeNetConfig]] = {
    "nm_bm_two_phase": lambda: _uniform(
        dataclasses.replace(dev.rpu_nm_bm(), bm_mode="two_phase")),
}

# (a, b): the pairs whose order each figure claims
PAIRS = (("fig3a_baseline", "fig3b_nm_bm"),
         ("fig5_bl1", "fig5_bl1_um"),
         ("stress_a3_no_noise", "stress_a3_nm_bm"),
         ("nm_bm_two_phase", "fig3b_nm_bm"))
BAND_RUNS = tuple(dict.fromkeys(n for pair in PAIRS for n in pair))


def config(name: str) -> LeNetConfig:
    """The named run's configuration (:data:`RUNS` or :data:`EXTRA_RUNS`)."""
    return (RUNS.get(name) or EXTRA_RUNS[name])()


def on_kernels(cfg: LeNetConfig) -> LeNetConfig:
    """``cfg`` with every analog layer on the kernels (``use_pallas``) and,
    where its bound management is not iterative, the fused
    backward+update."""
    if cfg.policy is None:
        return cfg
    return dataclasses.replace(cfg, policy=cfg.policy.map_configs(
        lambda c: dataclasses.replace(
            c, use_pallas=True,
            fuse_bwd_update=not management.bm_is_iterative(c))))


def kernel_flags(cfg: LeNetConfig) -> Dict[str, Dict[str, bool]]:
    """The flags each analog layer runs with."""
    return {n: {"use_pallas": cfg.cfg(n).use_pallas,
                "fuse_bwd_update": cfg.cfg(n).fuse_bwd_update,
                "iterative_bm": management.bm_is_iterative(cfg.cfg(n))}
            for n in LAYERS if cfg.layer_mode(n) == "analog"}


def result_path(out: str, protocol: str, name: str, seed: int) -> str:
    return os.path.join(out, protocol, f"{name}_seed{seed}.json")


def run_one(name: str, seed: int, protocol: str = "compressed", *,
            out: str = RESULTS_DIR, device: str = "cuda",
            verbose: bool = False) -> Dict:
    """Train one run at one seed through the epoch engine; writes and
    returns its JSON payload."""
    import torch
    from repro_torch.train import cnn

    cfg = config(name)
    if torch.device(device).type == "cuda":
        cfg = on_kernels(cfg)
    proto = dict(PROTOCOLS[protocol], seed=seed)
    path = result_path(out, protocol, name, seed)
    r = cnn.train(cfg, verbose=verbose, device=device, engine="scan",
                  **proto)
    payload = cnn.log_payload(cfg, r["test_error"], proto["epochs"],
                              proto["batch"], proto["n_train"], seed,
                              extra=r)
    payload.update(run=name, protocol_name=protocol,
                   protocol=dict(proto), device=r["device"],
                   device_name=(torch.cuda.get_device_name(0)
                                if r["device"].startswith("cuda") else
                                "cpu"),
                   kernels=kernel_flags(cfg))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


def _names(args) -> List[str]:
    if args.pairs:
        return list(BAND_RUNS)
    if args.figure:
        return list(FIGURES[args.figure])
    if args.all:
        return list(RUNS)
    names = [s for s in args.runs.split(",") if s]
    for n in names:
        if n not in RUNS and n not in EXTRA_RUNS:
            raise SystemExit(f"unknown run {n!r}")
    return names


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    pick = ap.add_mutually_exclusive_group(required=True)
    pick.add_argument("--runs", default="", help="comma-separated run names")
    pick.add_argument("--figure", choices=sorted(FIGURES))
    pick.add_argument("--pairs", action="store_true",
                      help="the runs of the four figure-defining pairs")
    pick.add_argument("--all", action="store_true", help="all 26 runs")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--protocol", choices=("band", "compressed"),
                    default="compressed")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    names = _names(args)
    import torch
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()                 # one nvcc per source, together
    results: Dict[str, Dict[int, Dict]] = {}
    for name in names:
        for seed in seeds:
            r = run_one(name, seed, args.protocol, out=args.out,
                        device=args.device)
            results.setdefault(name, {})[seed] = r
            paper = PAPER.get(name)
            print(f"[suite] {name:<24} seed {seed}: mean_last5 "
                  f"{100 * r['mean_last5']:6.2f}%  final "
                  f"{100 * r['final_error']:6.2f}%  paper "
                  f"{'--' if paper is None else f'{paper:.2f}%'}  "
                  f"{r['steps_per_sec']:8.1f} steps/s  "
                  f"{r['wallclock_s']:7.1f}s", flush=True)
    summary = {n: [results[n][s]["mean_last5"] for s in seeds]
               for n in names}
    ok = True
    if args.pairs and args.protocol == "band":
        from repro_torch.benchmarks import bands
        verdicts = bands.decide_all(summary, bands.load())
        for v in verdicts:
            print(f"[bands] {bands.describe(v)}", flush=True)
        ok = all(v["ok"] for v in verdicts)
        summary = {"mean_last5": summary, "pairs": verdicts}
    print(json.dumps({"suite": summary, "seeds": seeds,
                      "protocol": args.protocol, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
