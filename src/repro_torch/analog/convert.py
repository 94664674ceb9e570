"""``convert_to_analog``: swap a digital model's dense sites onto RPU tiles.

Walks a parameter tree of nested dicts (and lists of per-layer dicts), finds
*dense sites* — ``{"w"[, "b"]}`` dicts with a 2-D weight — and replaces the
ones matched by an :class:`~repro_torch.analog.policy.AnalogPolicy` with
:class:`~repro_torch.analog.modules.AnalogState` tiles.  ``dense_apply``
dispatches on the parameter type, so the model code never changes.

Paths are slash-joined dict keys (``"layers/attn/q"``).  A list under a key
holds the layers of a stack: its elements share the path (no index in it),
as the stacked layers of the JAX package do, and each layer gets its own
tile whose device seed derives from ``fold_in(site_key, layer)`` — the JAX
package's seed schedule, so both packages give the same tile seeds.

:func:`from_jax_params` carries the JAX package's parameters across, and
:func:`from_jax_opt_state` an optimizer state over them.  The JAX package
stacks an LM's layers (one leaf per parameter across layers, the layer axis
first: ``layers``, and an encoder-decoder's ``enc_layers``);
:func:`stack_layers` writes the port's per-layer lists in that layout (the
LM checkpoint's) and :func:`unstack_layers` reads it back.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analog.modules import (AnalogLinear, AnalogMeta,
                                        AnalogState, ConvSpec)
from repro_torch.analog.policy import AnalogPolicy
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import prng

Params = Any

#: The keys whose value is a stack of layers (a list in the port).
STACKS = ("layers", "enc_layers")


def _is_dense_site(node: Any) -> bool:
    """A dict that *is* one dense layer: ``{"w"[, "b"]}``, 2-D weight."""
    if not isinstance(node, dict) or "w" not in node:
        return False
    if not set(node) <= {"w", "b"}:
        return False
    return getattr(node["w"], "ndim", None) == 2


def _site_key(key: prng.Key, path: str) -> prng.Key:
    return prng.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)


def convert_to_analog(params: Params, policy: AnalogPolicy, *,
                      key: Optional[prng.Key] = None,
                      normalize: Optional[Callable[[RPUConfig], RPUConfig]]
                      = None) -> Params:
    """Swap policy-matched dense sites to analog tiles.

    ``normalize`` optionally post-processes every resolved config (the LM
    path passes ``RPUConfig.normalized_for_lm``).  Unmatched sites, and
    sites matched by an explicit ``digital`` rule, are returned untouched.
    A converted site's digital weight is dropped from ``params`` as its
    tile is made (so peak memory stays near one copy of the model); the
    input tree must not be used afterwards.
    """
    key = prng.key(0) if key is None else key

    def walk(p, path: Tuple[str, ...], layer: Optional[int]):
        if isinstance(p, list):
            return [walk(e, path, i) for i, e in enumerate(p)]
        if not isinstance(p, dict):
            return p
        if _is_dense_site(p):
            path_str = "/".join(path)
            rule = policy.match(path_str)
            if rule is None or rule.cfg is None:
                return p
            cfg = normalize(rule.cfg) if normalize else rule.cfg
            k = _site_key(key, path_str)
            if layer is not None:
                k = prng.fold_in(k, layer)
            w, b = p.pop("w"), p.pop("b", None)
            return AnalogLinear.from_digital(k, w, cfg, b=b,
                                             label=rule.label)
        return {k: walk(v, path + (k,), layer) for k, v in p.items()}

    return walk(params, (), None)


def conversion_plan(params: Params) -> List[Tuple[str, str, Optional[RPUConfig]]]:
    """Rows ``(path, rule label, cfg-or-None)`` for every dense site (the
    layers of a stack appear once, under the stack's path)."""
    rows: List[Tuple[str, str, Optional[RPUConfig]]] = []

    def walk(p, path: Tuple[str, ...]):
        path_str = "/".join(path)
        if isinstance(p, list):
            if p:
                walk(p[0], path)
        elif isinstance(p, AnalogState):
            rows.append((path_str, p.meta.label or "analog", p.meta.cfg))
        elif _is_dense_site(p):
            rows.append((path_str, "digital", None))
        elif isinstance(p, dict):
            for k, v in p.items():
                walk(v, path + (k,))

    walk(params, ())
    return rows


# ---------------------------------------------------------------------------
# Parameters from the JAX package
# ---------------------------------------------------------------------------

def _port_cfg(cfg_like) -> RPUConfig:
    """The port's RPUConfig with the field values of a JAX RPUConfig (read
    by attribute name; ``dtype`` maps by its name)."""
    kw = {}
    for f in dataclasses.fields(RPUConfig):
        v = getattr(cfg_like, f.name)
        if f.name == "dtype":
            v = getattr(torch, np.dtype(v).name)
        elif f.name == "tile_grid" and v is not None:
            v = tuple(int(a) for a in v)
        kw[f.name] = v
    return RPUConfig(**kw)


def _is_jax_analog(node: Any) -> bool:
    return isinstance(node, dict) and set(node) - {"maps"} == {
        "w", "seed", "meta"}


def _port_conv(spec) -> Optional[ConvSpec]:
    if spec is None:
        return None
    pad = spec.padding
    if not isinstance(pad, str):
        pad = tuple((int(a), int(b)) for a, b in pad)
    return ConvSpec(kernel=tuple(int(v) for v in spec.kernel),
                    stride=tuple(int(v) for v in spec.stride), padding=pad,
                    dilation=tuple(int(v) for v in spec.dilation))


def from_jax_params(tree: Params, *, device="cuda") -> Params:
    """The JAX package's parameter tree (the LM's or LeNet's), as numpy
    arrays, -> the port's.

    ``tree`` holds nested dicts of numpy arrays; each ``AnalogState`` of the
    JAX tree arrives as ``{"w": array, "seed": key data, "meta": meta}``
    plus ``"maps": {"dw_up", "dw_dn", "bound"}`` when its device maps are
    materialized (the JAX meta object is read by attribute, a conv layer's
    geometry from ``meta.conv``).  Stacked sites — under the ``layers`` and
    ``enc_layers`` keys every leaf has a leading layer axis — are unstacked
    into a list of per-layer dicts, one tile per layer.  Leaves that are not dense sites
    (an SSD block's ``conv_w``, ``A_log``, ``D``, ``dt_bias`` and norm)
    come across as tensors, and a tree without ``unembed`` (tied
    embeddings) stays without it.
    """
    def leaf(a) -> torch.Tensor:
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":      # ml_dtypes: through its bits
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    def pick_leaf(a, i: Optional[int]):
        # a rank-0 leaf under a stack is an optimizer state's sentinel,
        # one for every layer
        return a if i is None or np.ndim(a) == 0 else np.asarray(a)[i]

    def analog(node, i: Optional[int]) -> AnalogState:
        pick = lambda a: pick_leaf(a, i)  # noqa: E731
        m = node["meta"]
        meta = AnalogMeta(cfg=_port_cfg(m.cfg), bias=bool(m.bias),
                          kind=m.kind, conv=_port_conv(getattr(m, "conv",
                                                               None)),
                          label=m.label)
        maps = node.get("maps")
        if maps is not None:
            maps = DeviceMaps(*(leaf(pick(maps[k])).contiguous()
                                for k in ("dw_up", "dw_dn", "bound")))
        seed = pick(node["seed"])
        seed = (prng.from_key_data(seed) if np.issubdtype(
            np.asarray(seed).dtype, np.integer) else leaf(seed))
        return AnalogState(leaf(pick(node["w"])).contiguous(), maps, seed,
                           meta)

    def conv(node, i: Optional[int]):
        if _is_jax_analog(node):
            return analog(node, i)
        if isinstance(node, dict):
            return {k: conv(v, i) for k, v in node.items()}
        return leaf(pick_leaf(node, i))

    out = {}
    for k, v in tree.items():
        if k in STACKS:
            n = _stack_depth(v)
            out[k] = [conv(v, i) for i in range(n)]
        else:
            out[k] = conv(v, None)
    return out


def _stack_depth(node) -> int:
    """The layer count of a stacked subtree (rank-0 sentinels carry no
    layer axis)."""
    if _is_jax_analog(node):
        node = {"w": node["w"], "seed": node["seed"]}
    if isinstance(node, dict):
        depths = [_stack_depth(v) for v in node.values()]
        return max(depths, default=0)
    return int(np.shape(node)[0]) if np.ndim(node) else 0


def from_jax_opt_state(state, *, device="cuda"):
    """The JAX package's optimizer state, as numpy arrays (tiles as
    :func:`from_jax_params` takes them), -> the port's: ``()`` for a
    stateless optimizer, AdamW's ``{"mu", "nu", "count"}`` with ``count``
    an int32 0-d tensor, or momentum's tree."""
    if isinstance(state, tuple) and not state:
        return ()
    if isinstance(state, dict) and set(state) == {"mu", "nu", "count"}:
        return {"mu": from_jax_params(state["mu"], device=device),
                "nu": from_jax_params(state["nu"], device=device),
                "count": torch.from_numpy(np.array(state["count"],
                                                   dtype=np.int32)
                                          ).to(device)}
    return from_jax_params(state, device=device)


# ---------------------------------------------------------------------------
# The stacked layout of an LM's layers
# ---------------------------------------------------------------------------

def _stack(nodes: List[Any]) -> Any:
    first = nodes[0]
    if isinstance(first, AnalogState):
        maps = None if first.maps is None else DeviceMaps(*(
            _stack([getattr(n.maps, f) for n in nodes])
            for f in ("dw_up", "dw_dn", "bound")))
        seeds = [n.seed for n in nodes]
        seed = (prng.KeyStack.of(seeds) if isinstance(first.seed, tuple)
                else _stack(seeds))
        return AnalogState(_stack([n.w for n in nodes]), maps, seed,
                           first.meta)
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, tuple):        # a host key
        return prng.KeyStack.of(nodes)
    if first.dim() == 0:                # a sentinel: one for the stack
        return first
    return torch.stack([t.detach() for t in nodes])


def _unstack(node: Any, n: int) -> List[Any]:
    if isinstance(node, AnalogState):
        ws, seeds = _unstack(node.w, n), _unstack(node.seed, n)
        maps = ([None] * n if node.maps is None else [
            DeviceMaps(*parts) for parts in zip(*(
                _unstack(getattr(node.maps, f), n)
                for f in ("dw_up", "dw_dn", "bound")))])
        return [AnalogState(w, m, s, node.meta)
                for w, m, s in zip(ws, maps, seeds)]
    if isinstance(node, dict):
        per = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: per[k][i] for k in node} for i in range(n)]
    if isinstance(node, prng.KeyStack):
        return [node[i] for i in range(n)]
    if node.dim() == 0:
        return [node.clone() for _ in range(n)]
    return [node[i].clone() for i in range(n)]


def _at_layers(tree: Any, fn: Callable[[str, Any], Any]) -> Any:
    """``tree`` with ``fn(key, value)`` applied to the value under every
    stack's key (tuples, e.g. ``(params, opt_state)``, and dicts
    walked)."""
    if isinstance(tree, tuple):
        return tuple(_at_layers(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: fn(k, v) if k in STACKS else _at_layers(v, fn)
                for k, v in tree.items()}
    return tree


def stack_layers(tree: Any) -> Any:
    """The port's LM tree (params, an optimizer state, or a tuple of
    them) in the JAX package's stacked layout: each ``layers`` list of
    per-layer dicts becomes one dict whose tensors carry a leading layer
    axis, the tiles' seeds a :class:`~repro_torch.utils.prng.KeyStack`,
    and an optimizer state's rank-0 sentinels one for the stack."""
    return _at_layers(tree, lambda _, node: _stack(node))


def unstack_layers(tree: Any, n_layers: int, enc_layers: int = 0) -> Any:
    """Inverse of :func:`stack_layers` for a stack of ``n_layers`` (and an
    encoder of ``enc_layers``)."""
    n = {"layers": n_layers, "enc_layers": enc_layers}
    return _at_layers(tree, lambda k, node: _unstack(node, n[k]))
