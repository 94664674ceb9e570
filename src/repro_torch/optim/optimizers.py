"""The training steps of the analog and digital models, as plain in-place
updates of the trainable tensors (under ``torch.no_grad()``).

``analog_sgd`` is the hardware-exact step ``w <- w - w_bar``: the analog
layers' backward returns ``w_bar = w - w_physically_updated`` (pulse update
and device bound clip happen in the backward pass, the learning rate enters
through the pulse gains), so subtraction with factor 1 is the only
admissible step.  ``sgd`` is the FP baseline's ``p <- p - lr * g``.
``mixed_analog`` routes each leaf of a policy-converted parameter tree to
one or the other.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

Step = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], None]


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


def leaves(tree: Any) -> List[Tuple[torch.Tensor, bool]]:
    """The trainable tensors of a parameter tree of nested dicts, in key
    order, each with whether it is an analog tile's weights (an
    ``AnalogState``'s ``w``; its maps and seed are not trained)."""
    from repro_torch.analog.modules import AnalogState
    if isinstance(tree, AnalogState):
        return [(tree.w, True)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [(tree, False)]
    return []


def mixed_analog(digital: Step) -> Callable[[Any, Sequence[torch.Tensor]],
                                            None]:
    """Per-leaf routing for policy-converted models (mixed analog/digital):
    ``update(tree, grads)`` with ``grads`` in :func:`leaves` order.  Leaves
    of an ``AnalogState`` take the hardware-exact step ``p - w_bar``
    (:func:`analog_sgd`); every other leaf takes ``digital`` (e.g.
    ``functools.partial(sgd, lr=lr)``).  A tree with no analog leaf takes
    ``digital`` alone."""

    def update(tree, grads):
        pairs = list(zip(leaves(tree), grads))
        for analog, step in ((True, analog_sgd), (False, digital)):
            mine = [(p, g) for (p, a), g in pairs if a == analog]
            if mine:
                step([p for p, _ in mine], [g for _, g in mine])

    return update
