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

:func:`from_jax_params` carries the JAX package's parameters across.
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
    geometry from ``meta.conv``).  Stacked sites — under the ``layers`` key
    every leaf has a leading layer axis — are unstacked into a list of
    per-layer dicts, one tile per layer.
    """
    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def analog(node, i: Optional[int]) -> AnalogState:
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        m = node["meta"]
        meta = AnalogMeta(cfg=_port_cfg(m.cfg), bias=bool(m.bias),
                          kind=m.kind, conv=_port_conv(getattr(m, "conv",
                                                               None)),
                          label=m.label)
        maps = node.get("maps")
        if maps is not None:
            maps = DeviceMaps(*(leaf(pick(maps[k])).contiguous()
                                for k in ("dw_up", "dw_dn", "bound")))
        return AnalogState(leaf(pick(node["w"])).contiguous(), maps,
                           prng.from_key_data(pick(node["seed"])), meta)

    def conv(node, i: Optional[int]):
        if _is_jax_analog(node):
            return analog(node, i)
        if isinstance(node, dict):
            return {k: conv(v, i) for k, v in node.items()}
        return leaf(node if i is None else np.asarray(node)[i])

    out = {}
    for k, v in tree.items():
        if k == "layers":
            n = _stack_depth(v)
            out[k] = [conv(v, i) for i in range(n)]
        else:
            out[k] = conv(v, None)
    return out


def _stack_depth(node) -> int:
    if _is_jax_analog(node):
        return int(np.shape(node["w"])[0])
    if isinstance(node, dict):
        return _stack_depth(next(iter(node.values())))
    return int(np.shape(node)[0])
