"""The trainer of the analog recurrent cells: LSTM/GRU on the
delayed-copy task (the JAX package's ``launch/train.py`` ``train_sequence``
and the lstm/gru branch of its CLI).

  python -m repro_torch.launch.train --arch lstm --analog --steps 5

``--steps`` counts *epochs* over a fixed synthetic split (the copy task is
tiny).  Every step runs the cell's time loop: temporal weight reuse on the
same tiles every timestep, one accumulated pulse update per sequence batch
(1806.00166's setting on this package's RPU substrate).  ``--engine scan``
(default) replays one CUDA graph per step (``train/engine.py``), ``--engine
python`` keeps the per-step loop as the oracle: both give the same tiles.

Bare ``--analog`` puts every site on ``rpu_nm_bm`` (NM and BM, no UM:
update management needs global error extrema, which a temporal
accumulation never has), with ``--bm-mode``, ``--use-pallas`` and
``--fuse-bwd-update`` setting its fields; ``--analog-policy`` takes the
JAX package's spec language instead (the same keys as ``:field=value``
modifiers).  The key layout is the JAX package's: params from
``key(seed)``, ``k_data, k_train, k_eval = split(key(seed + 1), 3)``,
evaluation after epoch ``e`` under ``fold_in(k_eval, e)``.  The epoch
shuffle is the port's (``engine.epoch_permutation``).

Runs on ``cuda`` unless the caller passes ``device="cpu"`` (``--device
cpu``).  The LM architectures of the JAX trainer are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict, Optional

import torch

from repro_torch.train import engine as eng
from repro_torch.utils import prng

SEQ_ARCHS = ("lstm", "gru")


def build(kind: str, *, batch: int, seq: int, smoke: bool, analog: bool,
          analog_policy: Optional[str], lr: float, bm_mode: str,
          use_pallas: bool, fuse_bwd_update: bool, time_chunk: int,
          seed: int, device):
    """The trainer's config, params (converted when analog), optimizer and
    the two splits as device tensors: ``(scfg, params, opt, train, eval)``
    with each split ``(tokens, targets)``."""
    from repro_torch.analog.convert import convert_to_analog
    from repro_torch.analog.policy import AnalogPolicy, AnalogRule
    from repro_torch.analog.presets import parse_policy
    from repro_torch.core.device import rpu_nm_bm
    from repro_torch.data import sequences
    from repro_torch.optim import optimizers
    from repro_torch.recurrent import model as seq_model

    seq_len = 4 if smoke else max(2, min(seq, 16))
    scfg = seq_model.SeqConfig(kind=kind, seq_len=seq_len, lr=lr,
                               hidden=16 if smoke else 32,
                               time_chunk=time_chunk)
    n_train = batch * (2 if smoke else 25)
    n_eval = max(batch, 64)
    splits = [sequences.copy_task(n, seq_len=scfg.seq_len, delay=scfg.delay,
                                  vocab=scfg.vocab, seed=s)
              for n, s in ((n_train, seed), (n_eval, seed + 1))]
    params = seq_model.init(prng.key(seed), scfg, device=device)
    pol = None
    if analog_policy:
        pol = parse_policy(analog_policy)
    elif analog:
        rpu = dataclasses.replace(rpu_nm_bm(), bm_mode=bm_mode,
                                  use_pallas=use_pallas,
                                  fuse_bwd_update=fuse_bwd_update)
        pol = AnalogPolicy(rules=(AnalogRule("*", rpu, "nm_bm"),))
    if pol is not None:
        params = convert_to_analog(params, pol, key=prng.key(seed))
    # with no analog leaf, mixed_analog is sgd(lr) itself
    opt = optimizers.mixed_analog(functools.partial(optimizers.sgd, lr=lr))
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    train, ev = ((as_t(tok), as_t(tgt)) for tok, tgt in splits)
    return scfg, params, opt, train, ev


def python_eval(scfg, params, tokens: torch.Tensor, targets: torch.Tensor,
                key: prng.Key, batch: int) -> float:
    """``engine="python"``'s evaluation: :func:`engine.make_seq_eval_fn`'s
    batches and keys (``fold_in(key, start)``), one Python call each."""
    from repro_torch.recurrent import model as seq_model
    counts = torch.zeros(2, device=tokens.device)
    with torch.no_grad():
        for start in range(0, tokens.shape[0], batch):
            t, g = tokens[start:start + batch], targets[start:start + batch]
            pad = batch - t.shape[0]
            if pad:
                t = torch.cat([t, t.new_zeros((pad, t.shape[1]))])
                g = torch.cat([g, g.new_full((pad, g.shape[1]), -1)])
            logits = seq_model.apply(params, t, prng.fold_in(key, start),
                                     scfg)
            counts.add_(torch.stack(seq_model.hits(logits, g)))
    return float(counts[0] / torch.clamp_min(counts[1], 1.0))


def train_sequence(kind: str, *, steps: int, batch: int, seq: int,
                   smoke: bool, analog: bool = False,
                   analog_policy: Optional[str] = None, lr: float = 0.01,
                   bm_mode: str = "iterative", use_pallas: bool = False,
                   fuse_bwd_update: bool = False, time_chunk: int = 1,
                   seed: int = 0, log_every: int = 1, device="cuda",
                   engine: str = "scan", return_params: bool = False,
                   verbose: bool = True) -> Dict:
    """Analog recurrent trainer: LSTM/GRU on the delayed-copy task.

    Returns the JAX package's ``{"losses", "final_loss", "accuracies"}``
    (``losses`` are ``1 - accuracy`` per epoch) plus ``"wallclock_s"``,
    ``"steps_per_sec"``, ``"engine"``, ``"device"`` (and ``"params"`` on
    request)."""
    from repro_torch.train import cnn
    if kind not in SEQ_ARCHS:
        raise ValueError(f"unknown sequence arch {kind!r}")
    if engine not in ("scan", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    scfg, params, opt, (tok, tgt), (ev_tok, ev_tgt) = build(
        kind, batch=batch, seq=seq, smoke=smoke, analog=analog,
        analog_policy=analog_policy, lr=lr, bm_mode=bm_mode,
        use_pallas=use_pallas, fuse_bwd_update=fuse_bwd_update,
        time_chunk=time_chunk, seed=seed, device=device)
    eval_batch = max(batch, 64)
    if engine == "scan":
        run_epoch = eng.make_seq_epoch_fn(scfg, opt, batch=batch)
        evaluate = eng.make_seq_eval_fn(scfg, batch=eval_batch)
    else:
        run_epoch = functools.partial(
            cnn.python_epoch, eng.make_seq_step_fn(scfg, opt), batch=batch)
        evaluate = functools.partial(python_eval, scfg, batch=eval_batch)
    k_data, k_train, k_eval = prng.split(prng.key(seed + 1), 3)

    accs = []
    t0 = time.perf_counter()
    for epoch in range(steps):
        run_epoch(params, tok, tgt, k_data, k_train, epoch)
        acc = evaluate(params, ev_tok, ev_tgt, prng.fold_in(k_eval, epoch))
        accs.append(acc)
        if verbose and (epoch % log_every == 0 or epoch == steps - 1):
            print(f"[train {kind}] epoch {epoch} copy-task accuracy "
                  f"{acc:.3f}", flush=True)
    wallclock = time.perf_counter() - t0
    result = {"losses": [1.0 - a for a in accs],
              "final_loss": 1.0 - accs[-1] if accs else None,
              "accuracies": accs, "wallclock_s": wallclock,
              "steps_per_sec": (steps * (tok.shape[0] // batch) / wallclock
                                if wallclock > 0 else None),
              "engine": engine, "device": str(torch.device(device))}
    if return_params:
        result["params"] = params
    return result


def train(arch: str, **kw) -> Dict:
    """The JAX trainer's ``train`` for the architectures the port has: the
    copy-task cells."""
    if arch not in SEQ_ARCHS:
        raise NotImplementedError(
            f"--arch {arch!r}: the port's trainer has only the "
            f"recurrent cells {SEQ_ARCHS}; the LM architectures wait for "
            "train/lm.py (ROADMAP Queue 1, item 6)")
    return train_sequence(arch, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="lstm or gru (the LM archs are not ported)")
    ap.add_argument("--steps", type=int, default=100,
                    help="epochs over the copy-task split")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="payload length, capped at 16 (T = 2 seq + 2)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--analog", action="store_true",
                    help="every site on rpu_nm_bm (NM + BM, no UM)")
    ap.add_argument("--analog-policy", type=str, default=None,
                    metavar="SPEC",
                    help="per-site analog policy (implies --analog): a "
                         "preset with ':field=value' modifiers, inline "
                         "first-match-wins rules or a JSON rules file, "
                         "over the sites cell/wx, cell/wh and readout")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--engine", choices=("scan", "python"), default="scan",
                    help="scan: one CUDA graph replay per step; python: "
                         "the per-step loop (the oracle)")
    ap.add_argument("--bm-mode", choices=("iterative", "two_phase"),
                    default="iterative",
                    help="with --analog: the paper's halve-and-retry loop "
                         "or the fixed-latency two-phase retry")
    ap.add_argument("--use-pallas", action="store_true",
                    help="with --analog: reads and updates on the CUDA "
                         "kernels")
    ap.add_argument("--fuse-bwd-update", action="store_true",
                    help="with --analog: each timestep's transpose read "
                         "and counts in one kernel launch (needs "
                         "--use-pallas and a fixed-latency BM mode)")
    ap.add_argument("--time-chunk", type=int, default=1,
                    help="timesteps per chunk of the JAX package's scan; "
                         "must divide T, changes no bit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                smoke=args.smoke, analog=args.analog,
                analog_policy=args.analog_policy, lr=args.lr,
                engine=args.engine, bm_mode=args.bm_mode,
                use_pallas=args.use_pallas,
                fuse_bwd_update=args.fuse_bwd_update,
                time_chunk=args.time_chunk, seed=args.seed,
                device=args.device)
    print(f"[train] done; final loss {res['final_loss']:.4f} "
          f"({res['steps_per_sec']:.1f} steps/s on {res['device']}, "
          f"engine {res['engine']})")


if __name__ == "__main__":
    main()
