"""Serving driver: static batched greedy decode (prefill + ``gen - 1``
decode steps) or continuous batching, of random weights drawn from
``--seed``.

  python -m repro_torch.launch.serve --arch deepseek_7b \\
      --analog-policy 'lm_managed:use_pallas=true:bm_mode=two_phase' \\
      --batch 4 --prompt-len 32 --gen 16

Continuous (``--continuous``): rotate a synthetic request stream through a
fixed pool of cache slots (``serve/scheduler.py``), requests admitted
mid-decode as slots free up:

  python -m repro_torch.launch.serve --arch hymba_1_5b --smoke \\
      --continuous --slots 4 --requests 16 --analog-policy lm_managed

``--arch`` takes every arch of ``configs/registry.py``: the dense
deepseek_7b, stablelm_3b and qwen3_14b, the ssm mamba2_130m, the hybrid
hymba_1_5b and the encoder-decoder seamless_m4t_medium, whose speech
frontend is a stub: ``prompt_len`` random frames per row (``make_frames``,
as the JAX driver draws them) feed its encoder (static batches only).
``--analog-policy`` takes the JAX package's spec language (a preset with
``:field=value`` modifiers, inline first-match-wins rules, or a JSON rules
file) and prints the resolved per-layer policy table.  Runs on
the card (``--device cuda``, the default) unless ``--device cpu`` is given.
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


def print_policy_table(params, who: str = "serve") -> None:
    """Resolved per-layer policy table."""
    from repro_torch.analog.convert import conversion_plan
    from repro_torch.analog.presets import describe_cfg
    print(f"[{who}] resolved analog policy (layer -> rule -> knobs):")
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


def make_frames(cfg, batch: int, prompt_len: int, seed: int, device):
    """An encoder-decoder's stub frames (None for other families): the JAX
    driver's ``normal(0, 0.5, (batch, prompt_len, d_model))``, drawn after
    the prompts from the same generator, in the act dtype."""
    if cfg.encoder_layers == 0:
        return None
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab, (batch, prompt_len))     # the prompts' draw
    frames = rng.normal(0, 0.5, (batch, prompt_len, cfg.d_model))
    return torch.from_numpy(frames).to(device=device, dtype=cfg.act_dtype)


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
    frames = make_frames(cfg, batch, prompt_len, seed, device)
    t0 = time.perf_counter()
    with torch.no_grad():
        out, _ = engine.greedy_generate(params, prompts, cfg, n_steps=gen,
                                        max_seq=prompt_len + gen,
                                        enc_embeds=frames, akey=akey)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[serve {arch}] generated {out.shape} in {dt:.2f}s "
          f"({batch * gen / dt:.1f} tok/s) on {device}")
    return out


def make_requests(cfg, *, n_requests: int, prompt_len: int, gen: int,
                  slots: int, seed: int):
    """The JAX driver's synthetic stream: prompt lengths in [P/2, P], new
    tokens in [G/2, G], Poisson arrivals spread over the slots."""
    from repro_torch.serve import scheduler as sched
    rng = np.random.default_rng(seed)
    return [sched.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab,
                            size=max(1, int(rng.integers(
                                prompt_len // 2, prompt_len + 1)))
                            ).astype(np.int32),
        max_new_tokens=max(1, int(rng.integers(gen // 2, gen + 1))),
        arrival=int(rng.poisson(1.0) * i // max(1, slots)))
        for i in range(n_requests)]


def serve_continuous(arch: str, *, slots: int, n_requests: int,
                     prompt_len: int, gen: int, smoke: bool = False,
                     seed: int = 0, analog_policy: Optional[str] = None,
                     data_mesh: Optional[int] = None, device="cuda",
                     params=None, akey=None):
    """Continuous batching over a synthetic Poisson request stream; returns
    the completions.  ``params``/``akey`` reuse an earlier ``init``."""
    from repro_torch.serve import scheduler as sched
    cfg = build_cfg(arch, smoke, analog_policy)
    if params is None:
        params, akey = init(cfg, seed, device)
    plan = sched.MeshPlan(data=data_mesh) if data_mesh else None
    reqs = make_requests(cfg, n_requests=n_requests, prompt_len=prompt_len,
                         gen=gen, slots=slots, seed=seed)
    s = sched.ContinuousBatchingScheduler(params, cfg, slots=slots,
                                          max_seq=prompt_len + gen,
                                          akey=akey, plan=plan)
    t0 = time.perf_counter()
    done = s.run(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done)
    print(f"[serve {arch}] continuous: {len(done)}/{n_requests} requests, "
          f"{n_tok} tokens over {slots} slots in {dt:.1f}s "
          f"({len(done) / dt:.1f} req/s, {n_tok / dt:.1f} tok/s) on "
          f"{device}")
    return done


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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: admit a synthetic request "
                         "stream mid-decode into freed cache slots "
                         "(serve/scheduler.py) instead of one static batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="cache slots (max concurrent decodes) with "
                         "--continuous")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to stream with --continuous")
    ap.add_argument("--data-mesh", type=int, default=None, metavar="N",
                    help="with --continuous: shard the cache slots over N "
                         "data replicas (above 1 raises: one card)")
    args = ap.parse_args()
    if args.continuous:
        serve_continuous(args.arch, slots=args.slots,
                         n_requests=args.requests,
                         prompt_len=args.prompt_len, gen=args.gen,
                         smoke=args.smoke, seed=args.seed,
                         analog_policy=args.analog_policy,
                         data_mesh=args.data_mesh, device=args.device)
    else:
        serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, smoke=args.smoke, seed=args.seed,
              analog_policy=args.analog_policy, device=args.device)


if __name__ == "__main__":
    main()
