"""The JAX package's optimizers (``optim/optimizers.py``) on parameter trees
of tensors, as in-place updates under ``torch.no_grad()``.

An :class:`Optimizer` is an ``(init, update)`` pair: ``init(params) ->
state`` and ``update(grads, state, params) -> (params, state)``.  The
update writes the new values into the parameter and state tensors (and
returns the same objects), so a captured CUDA graph that replays it steps
the live tensors.  Every state is a tree whose leaves are all device
tensors, ``adamw``'s step ``count`` too (an int32 0-d tensor, advanced on
the device), and it mirrors the parameter tree leaf for leaf as the JAX
package's does: a leaf that is not a float (a tile's seed) gets a rank-0
float32 sentinel, and under :func:`mixed_analog` so does every leaf of an
analog tile.  ``grads`` mirrors ``params``, with ``None`` where a leaf takes
no gradient (:func:`grad_tree` makes it from ``torch.autograd.grad``'s list
over :func:`leaves`).

``analog_sgd`` is the hardware-exact step ``w <- w - w_bar``: the analog
layers' backward returns ``w_bar = w - w_physically_updated`` (pulse update
and device bound clip happen in the backward pass, the learning rate enters
through the pulse gains), so subtraction with factor 1 is the only
admissible step.  ``sgd`` is the FP baseline's ``p <- p - lr * g``.
``mixed_analog`` routes each leaf of a policy-converted parameter tree to
one or the other.

The CNN and sequence trainers call the stateless steps in their list form:
``analog_sgd(params, grads)``, ``sgd(params, grads, lr)`` and
``mixed_analog(step)(tree, grads)`` with ``step(params, grads)`` and
``grads`` in :func:`leaves` order.
"""

from __future__ import annotations

from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.analog.modules import AnalogState
from repro_torch.core.device import DeviceMaps

PyTree = Any
OptState = Any
Step = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], None]


class Optimizer(NamedTuple):
    """``update(grads, state, params) -> (params, state)`` applies the step
    in place, keeping the training loop uniform between analog and digital
    modes."""
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], Tuple[PyTree, OptState]]


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``.
    Nodes: dicts (in key order), lists, :class:`AnalogState` (``w``,
    ``maps``, ``seed``; its meta kept) and :class:`DeviceMaps`; ``None`` is
    structure (no leaf); anything else is a leaf (a tile's host key too).
    A ``None`` in ``rest`` where ``tree`` has a node stands for a subtree of
    ``None`` leaves."""
    if tree is None:
        return None
    sub = lambda r, k: None if r is None else (  # noqa: E731
        r[k] if isinstance(k, (str, int)) and isinstance(r, (dict, list))
        else getattr(r, k))
    if isinstance(tree, (AnalogState, DeviceMaps)):
        fields = (("w", "maps", "seed") if isinstance(tree, AnalogState)
                  else ("dw_up", "dw_dn", "bound"))
        kids = [tree_map(fn, getattr(tree, f), *(sub(r, f) for r in rest))
                for f in fields]
        if isinstance(tree, AnalogState):
            return AnalogState(*kids, tree.meta)
        return DeviceMaps(*kids)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(sub(r, k) for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(sub(r, i) for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _skippable(p, g) -> bool:
    return g is None or not _is_float(p)


def _zeros_like_or_sentinel(p) -> torch.Tensor:
    if _is_float(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = p.device if isinstance(p, torch.Tensor) else "cpu"
    return torch.zeros((), dtype=torch.float32, device=dev)


def leaves(tree: Any) -> List[Tuple[torch.Tensor, bool]]:
    """The trainable tensors of a parameter tree of nested dicts and lists,
    in key order, each with whether it is an analog tile's weights (an
    ``AnalogState``'s ``w``; its maps and seed are not trained)."""
    if isinstance(tree, AnalogState):
        return [(tree.w, True)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [(tree, False)]
    return []


def grad_tree(params: PyTree, grads: Sequence[torch.Tensor]) -> PyTree:
    """The gradients of :func:`leaves` order as a tree mirroring
    ``params`` (``None`` at every leaf that takes none)."""
    it = iter(grads)

    def place(node):
        if isinstance(node, AnalogState):
            return AnalogState(next(it), None, None, node.meta)
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        if isinstance(node, list):
            return [place(v) for v in node]
        return next(it) if _is_float(node) else None

    out = place(params)
    if next(it, None) is not None:
        raise ValueError("more gradients than trainable leaves")
    return out


def assert_scan_carry_safe(state: OptState, what: str = "optimizer state"):
    """Raise ``TypeError`` unless every leaf of ``state`` is a tensor: a
    Python scalar, a host key or a ``None`` placeholder cannot be stepped
    in place by a replayed graph.  ``()`` (a stateless optimizer's state)
    has no leaf."""
    def check(leaf):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{what} leaf {leaf!r} is not scan-carry-safe "
                            f"(expected a tensor, got {type(leaf).__name__})")

    if not (isinstance(state, tuple) and not state):
        tree_map(check, state)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _stateless(step_leaf: Callable[[torch.Tensor, torch.Tensor], None]
               ) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        def step(p, g):
            if not _skippable(p, g):
                step_leaf(p, g)
        tree_map(step, params, grads)
        return params, state

    return Optimizer(init, update)


def analog_sgd(params: Optional[Sequence[torch.Tensor]] = None,
               grads: Optional[Sequence[torch.Tensor]] = None):
    """Hardware-exact step ``w <- w - w_bar``: ``analog_sgd()`` is the
    :class:`Optimizer`; ``analog_sgd(params, grads)`` steps two lists."""
    if params is None:
        return _stateless(lambda p, g: p.sub_(g))
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g)


def sgd(*args, lr: Optional[float] = None):
    """``p <- p - lr * g``: ``sgd(lr)`` is the :class:`Optimizer`;
    ``sgd(params, grads, lr)`` steps two lists."""
    if len(args) < 2:
        rate = args[0] if args else lr
        return _stateless(lambda p, g: p.sub_(rate * g))
    params, grads = args[:2]
    rate = args[2] if len(args) > 2 else lr
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(rate * g)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    """Heavy-ball momentum with float32 buffers."""
    def init(params):
        return tree_map(_zeros_like_or_sentinel, params)

    @torch.no_grad()
    def update(grads, state, params):
        def upd(p, g, m):
            if _skippable(p, g):
                return
            g32 = g.to(torch.float32)
            m.mul_(beta).add_(g32)
            d = g32 + beta * m if nesterov else m
            p.copy_((p.to(torch.float32) - lr * d).to(p.dtype))
        tree_map(upd, params, grads, state)
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with float32 moments; the step count an int32 0-d tensor on
    the parameters' device, and the bias corrections ``1 - b ** count``
    computed there in float32."""
    def init(params):
        zeros = tree_map(_zeros_like_or_sentinel, params)
        dev = next((p.device for p, _ in leaves(params)), "cpu")
        return {"mu": zeros, "nu": tree_map(torch.zeros_like, zeros),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"]
        count.add_(1)
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)

        def upd(p, g, m, v):
            if _skippable(p, g):
                return
            g32 = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.to(torch.float32)
            if weight_decay:
                step = step + weight_decay * p32
            p.copy_((p32 - lr * step).to(p.dtype))

        tree_map(upd, params, grads, state["mu"], state["nu"])
        return params, state

    return Optimizer(init, update)


def _by_kind(tree: PyTree, analog: Callable, digital: Callable) -> PyTree:
    """``tree`` with each leaf of an analog tile mapped by ``analog`` (the
    tile's structure and meta kept) and every other leaf by
    ``digital``."""
    if isinstance(tree, AnalogState):
        return tree_map(analog, tree)
    if isinstance(tree, dict):
        return {k: _by_kind(v, analog, digital) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_by_kind(v, analog, digital) for v in tree]
    return digital(tree)


def mixed_analog(digital):
    """Per-leaf routing for policy-converted models (mixed analog/digital).

    Leaves of an ``AnalogState`` take the hardware-exact analog step ``p -
    w_bar`` (the layers' backward already folds learning rate, pulse
    statistics and the device-bound clip into the cotangent); every other
    leaf is delegated to ``digital``.  With an :class:`Optimizer` (e.g.
    ``adamw(lr)``) the result is one: its state is ``digital``'s over the
    tree with each analog leaf masked to a rank-0 sentinel, so no moment
    is kept for a tile.  With a list step ``digital(params, grads)`` (e.g.
    ``functools.partial(sgd, lr=lr)``) the result is ``update(tree,
    grads)`` with ``grads`` in :func:`leaves` order; a tree with no analog
    leaf takes ``digital`` alone."""
    if not isinstance(digital, Optimizer):
        def step(tree, grads):
            pairs = list(zip(leaves(tree), grads))
            for analog, fn in ((True, analog_sgd), (False, digital)):
                mine = [(p, g) for (p, a), g in pairs if a == analog]
                if mine:
                    fn([p for p, _ in mine], [g for _, g in mine])
        return step

    keep, drop = (lambda x: x), (lambda x: None)
    tiles = analog_sgd()

    def sentinel(leaf):
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return torch.zeros((), dtype=torch.float32, device=dev)

    def init(params):
        return digital.init(_by_kind(params, sentinel, keep))

    def update(grads, state, params):
        digital.update(_by_kind(grads, drop, keep), state, params)
        tiles.update(_by_kind(grads, keep, drop), (), params)
        return params, state

    return Optimizer(init, update)
