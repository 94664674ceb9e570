"""The training steps of the analog and digital LeNet, as plain in-place
updates of the trainable tensors (under ``torch.no_grad()``).

``analog_sgd`` is the hardware-exact step ``w <- w - w_bar``: the analog
layers' backward returns ``w_bar = w - w_physically_updated`` (pulse update
and device bound clip happen in the backward pass, the learning rate enters
through the pulse gains), so subtraction with factor 1 is the only
admissible step.  ``sgd`` is the FP baseline's ``p <- p - lr * g``.
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def analog_sgd(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> None:
    for p, g in zip(params, grads):
        p.sub_(g)


@torch.no_grad()
def sgd(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
        lr: float) -> None:
    for p, g in zip(params, grads):
        p.sub_(lr * g)
