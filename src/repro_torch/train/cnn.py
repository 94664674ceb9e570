"""Training driver of the paper's CNN experiments: SGD at a fixed eta,
epoch-wise test error, analog or FP mode, one Python step per minibatch
(the JAX package's ``engine="python"``).

Key schedule (the JAX package's): ``k_init, k_data, k_train, k_eval =
split(key(seed), 4)``; step ``s`` of epoch ``e`` draws its noise from
``fold_in(k_train, e * steps_per_epoch + s)``; evaluation after epoch ``e``
reads batch ``i`` of 256 images under ``fold_in(fold_in(k_eval, e),
i * 256)``.  The epoch shuffle is a ``torch.randperm`` seeded from the key
data of ``fold_in(k_data, e)``: not the JAX package's
``jax.random.permutation`` (parity tests feed both the same batches).

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.models import lenet
from repro_torch.optim import optimizers
from repro_torch.utils import prng


def trainable(params) -> List[torch.Tensor]:
    """The tiles' physical weights, made leaves that take a gradient."""
    return [params[name].w.requires_grad_() for name in lenet.LAYERS]


def make_train_step(cfg: lenet.LeNetConfig):
    """``step(params, images, labels, key)``: one SGD step in place
    (``analog_sgd`` in analog mode, ``sgd(lr)`` in digital mode); returns
    the summed loss (a device scalar)."""
    def step(params, images, labels, key):
        ws = trainable(params)
        loss = lenet.loss_fn(params, images, labels, key, cfg)
        grads = torch.autograd.grad(loss, ws)
        if cfg.mode == "analog":
            optimizers.analog_sgd(ws, grads)
        else:
            optimizers.sgd(ws, grads, cfg.lr)
        return loss.detach()

    return step


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


def epoch_permutation(k_data: prng.Key, epoch: int, n: int) -> torch.Tensor:
    """The epoch's shuffle: ``torch.randperm`` under a generator seeded from
    the key data of ``fold_in(k_data, epoch)``."""
    k0, k1 = prng.fold_in(k_data, epoch)
    g = torch.Generator().manual_seed((k0 << 32) | k1)
    return torch.randperm(n, generator=g)


def train(cfg: lenet.LeNetConfig, *, epochs: int = 15, batch: int = 8,
          n_train: int = 8192, n_test: int = 2048, seed: int = 0,
          verbose: bool = True, return_params: bool = False,
          device="cuda") -> Dict:
    """Train per the paper's protocol; returns ``{"test_error": [...],
    "final_error", "mean_last5", "std_last5", "wallclock_s",
    "steps_per_sec", "device"}`` (and ``"params"`` on request)."""
    from repro_torch.data import mnist
    (xtr, ytr), (xte, yte) = mnist.load_splits(n_train, n_test, seed=seed,
                                               verbose=verbose)
    k_init, k_data, k_train, k_eval = prng.split(prng.key(seed), 4)
    params = lenet.init(k_init, cfg, device=device)
    step = make_train_step(cfg)
    evaluate = make_eval(cfg)
    xtr_d, ytr_d = torch.from_numpy(xtr).to(device), torch.from_numpy(
        ytr).to(device)
    xte_d, yte_d = torch.from_numpy(xte).to(device), torch.from_numpy(
        yte).to(device)

    history: List[float] = []
    spe = len(xtr) // batch
    t0 = time.perf_counter()
    for epoch in range(epochs):
        perm = epoch_permutation(k_data, epoch, len(xtr)).to(device)
        for s in range(spe):
            idx = perm[s * batch:(s + 1) * batch]
            step(params, xtr_d[idx], ytr_d[idx],
                 prng.fold_in(k_train, epoch * spe + s))
        err = evaluate(params, xte_d, yte_d, prng.fold_in(k_eval, epoch))
        history.append(err)
        if verbose:
            print(f"[epoch {epoch + 1:3d}/{epochs}] test error "
                  f"{100 * err:6.2f}%  ({time.perf_counter() - t0:6.1f}s)",
                  flush=True)
    wallclock = time.perf_counter() - t0
    result = {
        "test_error": history,
        "final_error": history[-1] if history else None,
        "mean_last5": float(np.mean(history[-5:])) if history else None,
        "std_last5": float(np.std(history[-5:])) if history else None,
        "wallclock_s": wallclock,
        "steps_per_sec": epochs * spe / wallclock if wallclock > 0 else None,
        "device": str(torch.device(device)),
    }
    if return_params:
        result["params"] = params
    return result
