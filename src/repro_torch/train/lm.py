"""LM training step: loss, gradients, optimizer application, metrics (the
JAX package's ``train/lm.py``).

Analog (RPU) mode runs through the same path: the analog layers' autograd
function turns the backward pass into the paper's three-cycle update, and
``optim.analog_sgd`` (alone, or inside ``mixed_analog``) applies it.  The
step updates the parameters and the optimizer state in place, so the
graphed engine (``train/engine.py``) can replay it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import (Optimizer, adamw, analog_sgd,
                                          mixed_analog)

Tensor = torch.Tensor

AUX_LOSS_WEIGHT = 0.01


def loss_fn(params, batch: Dict[str, Tensor], cfg: ModelConfig,
            key=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross entropy (+ aux).  ``batch['tokens']`` (B, S); an
    encoder-decoder's ``batch['enc_embeds']`` (B, S_src, d) feed its
    encoder."""
    akey = key if cfg.uses_analog else None
    tokens = batch["tokens"]
    logits, aux = transformer.forward(params, tokens[:, :-1], cfg,
                                      enc_embeds=batch.get("enc_embeds"),
                                      akey=akey)
    targets = tokens[:, 1:].to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp_max(loss, 20.0))}


def default_optimizer(cfg: ModelConfig, lr: float = 3e-4) -> Optimizer:
    if cfg.analog_policy is not None:
        # mixed per-layer policies: analog tiles take the hardware-exact
        # ``p - w_bar`` step, unmatched (digital) layers keep AdamW
        return mixed_analog(adamw(lr))
    if cfg.analog is not None:
        # the legacy uniform-analog field keeps its optimizer
        return analog_sgd()
    return adamw(lr)


def make_train_step(cfg: ModelConfig, opt: Optional[Optimizer] = None):
    """``(train_step, opt)``; ``train_step(params, opt_state, batch, key)
    -> (params, opt_state, metrics)`` steps params and state in place (and
    returns them); ``key`` is a host key or a key tape's device key."""
    opt = opt or default_optimizer(cfg)

    def train_step(params, opt_state, batch, key):
        ws = [t.requires_grad_() for t, _ in optimizers.leaves(params)]
        total, metrics = loss_fn(params, batch, cfg, key)
        grads = torch.autograd.grad(total, ws)
        for t in ws:
            t.requires_grad_(False)
        params, opt_state = opt.update(optimizers.grad_tree(params, grads),
                                       opt_state, params)
        return params, opt_state, {k: v.detach() for k, v in
                                   metrics.items()}

    return train_step, opt


def make_scan_train_step(cfg: ModelConfig, opt: Optional[Optimizer] = None):
    """``(multi_step, opt)``: ``multi_step(params, opt_state, batches,
    base, step0)`` runs one chunk of steps, ``batches`` a batch dict whose
    leaves lead with the chunk axis, and step
    ``step0 + i`` under ``fold_in(base, step0 + i)`` (see
    :func:`repro_torch.train.engine.scan_steps`), each one CUDA graph
    replay on a card; metrics come back stacked along the chunk."""
    from repro_torch.train.engine import scan_steps
    step, opt = make_train_step(cfg, opt)
    return scan_steps(step), opt


def init_train_state(seed: int, cfg: ModelConfig,
                     opt: Optional[Optimizer] = None, device="cuda",
                     jax_weights: bool = False):
    """Concrete params + optimizer state on ``device`` (the JAX package's
    also returns the logical-axes tree, which one card does not use);
    ``jax_weights``: the JAX package's initial weights
    (``transformer.init_lm``)."""
    opt = opt or default_optimizer(cfg)
    params = transformer.init_lm(seed, cfg, device=device,
                                 jax_weights=jax_weights)
    return params, opt.init(params)
