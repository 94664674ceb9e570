"""Training driver of the paper's CNN experiments: SGD at a fixed eta,
epoch-wise test error, analog or FP mode.  Two engines, the JAX package's
names: ``engine="scan"`` (default), the epoch engine of
:mod:`repro_torch.train.engine` (one CUDA graph replay per step, its keys
derived on the card), and ``engine="python"``, one Python step per
minibatch with its keys derived on the host, kept as the oracle: both give
the same parameters.

Key schedule (the JAX package's): ``k_init, k_data, k_train, k_eval =
split(key(seed), 4)``; step ``s`` of epoch ``e`` draws its noise from
``fold_in(k_train, e * steps_per_epoch + s)``; evaluation after epoch ``e``
reads batch ``i`` of 256 images under ``fold_in(fold_in(k_eval, e),
i * 256)``.  The epoch shuffle is a ``torch.randperm`` seeded from the key
data of ``fold_in(k_data, e)``: not the JAX package's
``jax.random.permutation`` (parity tests feed both the same batches).

``log_path`` writes the JAX package's JSON history (the same keys: the
layers' device settings from :func:`_describe`, the protocol, the test
errors and, at the end, the result).

Memory: a ``LeNetConfig.with_stream_chunks(update_chunk,
conv_stream_chunk)`` config streams the conv position columns and the
update cycle's pulse streams in chunks, so one chunk of columns and
streams is live at a time instead of every position's; training keeps its
bits under BM off and two-phase BM (``core/conv_mapping.py``).

Checkpoint and resume (``ckpt_dir``, ``ckpt_every``): the JAX package's
async epoch-boundary checkpoints of ``(params, ())`` in its store's layout
(:mod:`repro_torch.checkpoint.store`), and a restarted run continues from
the newest complete one.  Only the tiles and the history are saved: every
draw is indexed absolutely, so neither engine has state of its own to
keep.  The epoch engine sets its device step counter from
``epoch * steps_per_epoch`` and its shuffle from ``fold_in(k_data,
epoch)`` at each epoch and derives the step's key tape from the counter;
evaluation reads ``fold_in(k_eval, epoch)``.  A resumed run therefore gives
the bits of the run that was never interrupted.  The JAX package's
trainer reshards restored tiles onto its mesh (``reshard_analog``); one
card has no counterpart of that.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import lenet
from repro_torch.train import engine as eng
from repro_torch.train.engine import epoch_permutation
from repro_torch.utils import prng


def make_train_step(cfg: lenet.LeNetConfig, opt=None):
    """``step(params, images, labels, key)``: one SGD step in place,
    ``opt(ws, grads)`` (default ``analog_sgd`` in analog mode, ``sgd(lr)``
    in digital mode); returns the summed loss (a device scalar).  The
    engine's ``make_cnn_step_fn``.  The JAX package returns ``(step,
    opt)`` with a functional ``step(params, opt_state, ...)``; the port's
    optimizers update in place and keep no state, so only the step is
    returned."""
    return eng.make_cnn_step_fn(cfg, opt)


def make_eval(cfg: lenet.LeNetConfig, batch: int = 256):
    """``evaluate(params, xs, ys, key) -> error`` over batches of ``batch``
    images under ``fold_in(key, start)``; the last batch is padded with
    zero images that count for nothing."""
    @torch.no_grad()
    def evaluate(params, xs: torch.Tensor, ys: torch.Tensor,
                 key: prng.Key) -> float:
        n = xs.shape[0]
        correct = torch.zeros((), device=xs.device)
        for start in range(0, n, batch):
            x = xs[start:start + batch]
            y = ys[start:start + batch]
            pad = batch - x.shape[0]
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            logits = lenet.apply(params, x, prng.fold_in(key, start), cfg)
            hit = torch.argmax(logits[:batch - pad], dim=-1) == y
            correct = correct + torch.sum(hit)
        return 1.0 - float(correct) / n

    return evaluate


def python_epoch(step, params, xs: torch.Tensor, ys: torch.Tensor,
                 k_data: prng.Key, k_train: prng.Key, epoch: int,
                 batch: int) -> None:
    """One epoch of ``engine="python"``: a Python call of ``step`` per
    minibatch, the step keys ``fold_in(k_train, epoch * spe + s)`` derived
    on the host."""
    spe = xs.shape[0] // batch
    perm = epoch_permutation(k_data, epoch, xs.shape[0]).to(xs.device)
    for s in range(spe):
        idx = perm[s * batch:(s + 1) * batch]
        step(params, xs[idx], ys[idx], prng.fold_in(k_train, epoch * spe + s))


def train(cfg: lenet.LeNetConfig, *, epochs: int = 15, batch: int = 8,
          n_train: int = 8192, n_test: int = 2048, seed: int = 0,
          log_path: Optional[str] = None, verbose: bool = True,
          eval_every_epoch: bool = True, return_params: bool = False,
          device="cuda", engine: str = "scan",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 1) -> Dict:
    """Train per the paper's protocol; returns ``{"test_error": [...],
    "final_error", "mean_last5", "std_last5", "wallclock_s",
    "steps_per_sec", "engine", "device"}`` (and ``"params"`` on request).
    ``engine``: ``"scan"`` (the epoch engine) or ``"python"`` (the
    per-step loop).  Without ``eval_every_epoch`` only the last epoch is
    evaluated; ``log_path`` gets the JSON history after each evaluation
    and the result at the end.

    ``ckpt_dir`` turns on async checkpoints after every ``ckpt_every``-th
    epoch and the last, and resume: a restarted run restores the newest
    complete checkpoint (before the engine's first capture, so the graph
    holds the restored tiles) and continues from the next epoch, with the
    saved history.  The fault injector (``REPRO_FAULT_*``) is checked at
    each epoch boundary."""
    if engine not in ("scan", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    from repro_torch.data import mnist
    (xtr, ytr), (xte, yte) = mnist.load_splits(n_train, n_test, seed=seed,
                                               verbose=verbose)
    k_init, k_data, k_train, k_eval = prng.split(prng.key(seed), 4)
    params = lenet.init(k_init, cfg, device=device)
    history: List[float] = []
    start_epoch = 0
    ckpt = injector = None
    if ckpt_dir:
        from repro_torch.checkpoint import store
        from repro_torch.distributed.fault import FaultInjector
        ckpt = store.AsyncCheckpointer(ckpt_dir)
        injector = FaultInjector.from_env()
        latest = store.latest_step(ckpt_dir)
        if latest is not None:
            (params, _), meta = store.restore(ckpt_dir, latest, (params, ()))
            start_epoch = int(meta["epoch"])
            history = list(meta.get("history", []))
            if verbose:
                print(f"[cnn] resumed after epoch {start_epoch}", flush=True)
    if engine == "scan":
        run_epoch = eng.make_cnn_epoch_fn(cfg, batch=batch)
        evaluate = eng.make_cnn_eval_fn(cfg)
    else:
        step = make_train_step(cfg)
        run_epoch = functools.partial(python_epoch, step, batch=batch)
        evaluate = make_eval(cfg)
    xtr_d, ytr_d = torch.from_numpy(xtr).to(device), torch.from_numpy(
        ytr).to(device)
    xte_d, yte_d = torch.from_numpy(xte).to(device), torch.from_numpy(
        yte).to(device)

    spe = len(xtr) // batch
    t0 = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        if injector is not None:
            injector.check(epoch, flush=ckpt)
        run_epoch(params, xtr_d, ytr_d, k_data, k_train, epoch)
        if eval_every_epoch or epoch == epochs - 1:
            err = evaluate(params, xte_d, yte_d, prng.fold_in(k_eval, epoch))
            history.append(err)
            if verbose:
                print(f"[epoch {epoch + 1:3d}/{epochs}] test error "
                      f"{100 * err:6.2f}%  "
                      f"({time.perf_counter() - t0:6.1f}s)", flush=True)
            if log_path:
                _dump(log_path, cfg, history, epochs, batch, n_train, seed)
        if ckpt is not None and ((epoch + 1) % ckpt_every == 0
                                 or epoch == epochs - 1):
            # the host copy is taken here, before the next epoch's
            # in-place updates
            ckpt.save(epoch + 1, (params, ()),
                      {"epoch": epoch + 1, "history": history})
            if injector is not None:
                injector.check(epoch, saving=True)
    if ckpt is not None:
        ckpt.wait()
    wallclock = time.perf_counter() - t0
    result = {
        "test_error": history,
        "final_error": history[-1] if history else None,
        "mean_last5": float(np.mean(history[-5:])) if history else None,
        "std_last5": float(np.std(history[-5:])) if history else None,
        "wallclock_s": wallclock,
        "steps_per_sec": ((epochs - start_epoch) * spe / wallclock
                          if wallclock > 0 else None),
        "engine": engine,
        "device": str(torch.device(device)),
    }
    if log_path:
        _dump(log_path, cfg, history, epochs, batch, n_train, seed,
              extra=result)
    if return_params:
        result["params"] = params
    return result


def _describe(cfg: lenet.LeNetConfig) -> Dict:
    """The run's mode, rate and each layer's device settings, under the
    JAX package's keys."""
    out = {"mode": cfg.mode, "lr": cfg.lr}
    if cfg.policy:
        for name in lenet.LAYERS:
            c = cfg.resolved(name)
            if c is None:        # the policy pins this layer digital
                out[name] = {"mode": "digital", "rule": cfg.label(name)}
                continue
            out[name] = {
                "bl": c.bl, "nm": c.noise_management,
                "bm": c.bound_management, "um": c.update_management,
                "noise": c.read_noise, "bound": c.out_bound,
                "dpw": c.devices_per_weight, "dtod": c.dw_min_dtod,
                "ctoc": c.dw_min_ctoc, "imb": c.imbalance_dtod,
                "rule": cfg.label(name),
            }
    return out


def log_payload(cfg: lenet.LeNetConfig, history: List[float], epochs: int,
                batch: int, n_train: int, seed: int,
                extra: Optional[Dict] = None) -> Dict:
    """The ``log_path`` JSON: config, protocol, test errors and the result's
    other keys (the JAX package's; the device is not among them)."""
    payload = {
        "config": _describe(cfg),
        "protocol": {"epochs": epochs, "batch": batch, "n_train": n_train,
                     "seed": seed},
        "test_error": history,
    }
    if extra:
        payload.update({k: v for k, v in extra.items()
                        if k not in ("test_error", "device", "params")})
    return payload


def _dump(path, cfg, history, epochs, batch, n_train, seed, extra=None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(log_payload(cfg, history, epochs, batch, n_train, seed,
                              extra), f, indent=1)
