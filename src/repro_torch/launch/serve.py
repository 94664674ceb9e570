"""Serving driver: static batched greedy decode (prefill + ``gen - 1``
decode steps) of random weights drawn from ``--seed``.

  python -m repro_torch.launch.serve --arch deepseek_7b \\
      --analog-policy 'lm_managed:use_pallas=true:bm_mode=two_phase' \\
      --batch 4 --prompt-len 32 --gen 16

``--analog-policy`` takes the JAX package's spec language (a preset with
``:field=value`` modifiers, inline first-match-wins rules, or a JSON rules
file) and prints the resolved per-layer policy table.  Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given.  The
continuous-batching scheduler is not part of this package yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.serve import engine
from repro_torch.utils import prng


def print_policy_table(params) -> None:
    """Resolved per-layer policy table."""
    from repro_torch.analog.convert import conversion_plan
    from repro_torch.analog.presets import describe_cfg
    print("[serve] resolved analog policy (layer -> rule -> knobs):")
    for path, label, c in conversion_plan(params):
        print(f"  {path:<34} {label:<28} {describe_cfg(c)}")


def build_cfg(arch: str, smoke: bool, analog_policy: Optional[str]):
    from repro_torch.analog import presets
    cfg = registry.get_config(arch, smoke=smoke)
    if analog_policy:
        cfg = dataclasses.replace(
            cfg, analog_policy=presets.parse_policy(analog_policy),
            param_dtype=torch.float32)
    return cfg


def init(cfg, seed: int, device):
    """(params, akey): weights from ``seed``; the analog key is
    ``key(seed + 1)`` when the config has an analog policy."""
    from repro_torch.models import transformer
    params = transformer.init_lm(seed, cfg, device=device)
    if cfg.analog_policy is not None:
        print_policy_table(params)
    akey = prng.key(seed + 1) if cfg.analog_policy is not None else None
    return params, akey


def make_prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                           dtype=torch.int64, device=device)


def serve(arch: str, *, batch: int, prompt_len: int, gen: int,
          smoke: bool = False, seed: int = 0,
          analog_policy: Optional[str] = None, device="cuda",
          params=None, akey=None):
    """Static batched greedy decode; returns the tokens (batch, gen) as a
    numpy array.  ``params``/``akey`` reuse an earlier ``init``."""
    cfg = build_cfg(arch, smoke, analog_policy)
    if params is None:
        params, akey = init(cfg, seed, device)
    prompts = make_prompts(cfg, batch, prompt_len, seed, device)
    t0 = time.perf_counter()
    with torch.no_grad():
        out, _ = engine.greedy_generate(params, prompts, cfg, n_steps=gen,
                                        max_seq=prompt_len + gen, akey=akey)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[serve {arch}] generated {out.shape} in {dt:.2f}s "
          f"({batch * gen / dt:.1f} tok/s) on {device}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--analog-policy", type=str, default=None,
                    metavar="SPEC",
                    help="serve analog-converted params: a preset name "
                         "('lm_managed', 'noise_free', ...) with optional "
                         "':field=value' modifiers (e.g. "
                         "'lm_managed:use_pallas=true:bm_mode=two_phase'), "
                         "inline 'pattern=preset' rules, or a JSON rules "
                         "file")
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, smoke=args.smoke, seed=args.seed,
          analog_policy=args.analog_policy, device=args.device)


if __name__ == "__main__":
    main()
