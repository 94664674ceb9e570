"""Analog layer state: ``AnalogState`` + the ``AnalogLinear`` wrapper.

:class:`AnalogState` holds one crossbar tile — the physical weights ``w``
``(#_d * out_f, in_f[+1])``, the device-population ``seed`` (a threefry key,
from which the device maps are regenerated) — next to static metadata
(:class:`AnalogMeta`: the layer's RPUConfig, bias flag, kind and label).
``models.layers.dense_apply`` dispatches on ``isinstance(p, AnalogState)``,
so the device config travels with the parameters.

Materialized device maps and the conv layer are not part of this package
yet (``maps`` is always None).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import analog_linear as core_linear
from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AnalogMeta:
    """Static (hashable) metadata of one analog layer."""
    cfg: RPUConfig
    bias: bool = True
    kind: str = "linear"
    label: str = ""                   # preset/rule name (display only)


class AnalogState:
    """One crossbar tile: physical weights, device seed and metadata."""

    __slots__ = ("w", "maps", "seed", "meta")

    def __init__(self, w: Tensor, maps, seed: prng.Key, meta: AnalogMeta):
        self.w = w
        self.maps = maps
        self.seed = seed
        self.meta = meta

    def __repr__(self):
        return (f"AnalogState(w{tuple(self.w.shape)}, kind={self.meta.kind!r},"
                f" bias={self.meta.bias}, label={self.meta.label!r})")


def init_tile_seed(key: prng.Key) -> prng.Key:
    """The device-population seed ``init_tile`` keeps: the second half of
    ``split(key)`` (the first draws initial weights)."""
    return prng.split(key)[1]


class AnalogLinear:
    """Analog fully-connected layer over one crossbar tile."""

    kind = "linear"

    @staticmethod
    def apply(state: AnalogState, x: Tensor, key: Optional[prng.Key] = None,
              *, mode: str = "analog") -> Tensor:
        if mode != "digital" and key is None:
            raise ValueError(
                "analog reads draw physical noise: pass a PRNG key (or "
                "mode='digital' for key-free FP eval)")
        return core_linear.apply(state.w, x, key, state.meta.cfg,
                                 bias=state.meta.bias, mode=mode)

    @staticmethod
    def from_digital(key: prng.Key, w: Tensor, cfg: RPUConfig, *,
                     b: Optional[Tensor] = None, label: str = ""
                     ) -> AnalogState:
        """Program a digital dense weight ``w`` (d_in, d_out) — and an
        optional bias ``b`` (d_out,) on the extra input column — onto a
        tile.  With seeded maps the programming is exact.  ``w.T`` is used
        as is when it is contiguous (no copy)."""
        if not cfg.seeded_maps:
            raise NotImplementedError(
                "materialized device maps are not ported yet")
        w_phys = w.to(cfg.dtype).T                       # (out, in)
        if b is not None:
            w_phys = torch.cat([w_phys, b.to(cfg.dtype)[:, None]], dim=1)
        if cfg.devices_per_weight > 1:
            w_phys = w_phys.repeat(cfg.devices_per_weight, 1)
        meta = AnalogMeta(cfg=cfg, bias=b is not None, kind="linear",
                          label=label)
        return AnalogState(w_phys.contiguous(), None, init_tile_seed(key),
                           meta)
