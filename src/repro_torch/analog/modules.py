"""Analog layer state: ``AnalogState`` + the ``AnalogLinear`` and
``AnalogConv2d`` wrappers.

:class:`AnalogState` holds one crossbar tile — the physical weights ``w``
``(#_d * out_f, in_f[+1])``, the materialized device maps (or None when the
config regenerates them from the seed), the device-population ``seed`` (a
threefry key) — next to static metadata (:class:`AnalogMeta`: the layer's
RPUConfig, bias flag, kind, conv geometry and label).
``models.layers.dense_apply`` dispatches on ``isinstance(p, AnalogState)``,
so the device config travels with the parameters.

To train a tile, make ``w`` require a gradient: the backward pass then
returns ``w_bar`` (``core/analog_linear.py``) for ``optim.analog_sgd``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import analog_linear as core_linear
from repro_torch.core import conv_mapping as core_conv
from repro_torch.core import tile as tile_lib
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor
IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _freeze_padding(padding) -> Union[str, Tuple[Tuple[int, int], ...]]:
    """Padding as a hashable value (str, or nested int tuples)."""
    if isinstance(padding, str):
        return padding
    return tuple((int(a), int(b)) for a, b in padding)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static conv geometry carried by a conv :class:`AnalogState`."""
    kernel: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    padding: Union[str, Tuple[Tuple[int, int], ...]] = "VALID"
    dilation: Tuple[int, int] = (1, 1)


@dataclasses.dataclass(frozen=True)
class AnalogMeta:
    """Static (hashable) metadata of one analog layer."""
    cfg: RPUConfig
    bias: bool = True
    kind: str = "linear"              # 'linear' | 'conv'
    conv: Optional[ConvSpec] = None
    label: str = ""                   # preset/rule name (display only)


class AnalogState:
    """One crossbar tile: physical weights, device maps, seed, metadata."""

    __slots__ = ("w", "maps", "seed", "meta")

    def __init__(self, w: Tensor, maps: Optional[DeviceMaps], seed: prng.Key,
                 meta: AnalogMeta):
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
    def init(key: prng.Key, in_features: int, out_features: int,
             cfg: RPUConfig, *, bias: bool = True,
             init_scale: Optional[float] = None, label: str = "",
             device="cpu") -> AnalogState:
        """A new tile: the JAX package's initial weights and device maps
        from the same key (maps materialized unless ``cfg.seeded_maps``)."""
        w, maps, seed = core_linear.init(key, in_features, out_features, cfg,
                                         bias=bias, init_scale=init_scale,
                                         device=device)
        meta = AnalogMeta(cfg=cfg, bias=bias, kind="linear", label=label)
        return AnalogState(w, maps, seed, meta)

    @staticmethod
    def apply(state: AnalogState, x: Tensor, key: Optional[prng.Key] = None,
              *, lr: float = 1.0, mode: str = "analog",
              cfg: Optional[RPUConfig] = None) -> Tensor:
        cfg = state.meta.cfg if cfg is None else cfg
        if mode != "digital" and key is None:
            raise ValueError(
                "analog reads draw physical noise: pass a PRNG key (or "
                "mode='digital' for key-free FP eval)")
        return core_linear.apply(state.w, x, key, cfg, lr,
                                 bias=state.meta.bias, mode=mode,
                                 maps=state.maps, seed=state.seed)

    @staticmethod
    def from_digital(key: prng.Key, w: Tensor, cfg: RPUConfig, *,
                     b: Optional[Tensor] = None, label: str = ""
                     ) -> AnalogState:
        """Program a digital dense weight ``w`` (d_in, d_out) — and an
        optional bias ``b`` (d_out,) on the extra input column — onto a
        tile, as ``init_tile`` programs its own draw: with seeded maps
        exactly (``w.T`` taken as is when it is contiguous), with
        materialized maps clipped to each device's own bound."""
        w_phys = w.to(cfg.dtype).T                       # (out, in)
        if b is not None:
            w_phys = torch.cat([w_phys, b.to(cfg.dtype)[:, None]], dim=1)
        meta = AnalogMeta(cfg=cfg, bias=b is not None, kind="linear",
                          label=label)
        if cfg.seeded_maps:
            if cfg.devices_per_weight > 1:
                w_phys = w_phys.repeat(cfg.devices_per_weight, 1)
            return AnalogState(w_phys.contiguous(), None,
                               init_tile_seed(key), meta)
        w_t, maps, seed = tile_lib.init_tile(
            key, w_phys.shape[0], w_phys.shape[1], cfg, w_init=w_phys,
            device=w_phys.device)
        return AnalogState(w_t, maps, seed, meta)


class AnalogConv2d:
    """Analog 2-D convolution: the conv -> crossbar mapping, with the
    kernel/stride/padding/dilation geometry frozen into the state."""

    kind = "conv"

    @staticmethod
    def init(key: prng.Key, in_channels: int, out_channels: int,
             kernel: IntPair, cfg: RPUConfig, *, stride: IntPair = 1,
             padding="VALID", dilation: IntPair = 1, bias: bool = True,
             init_scale: Optional[float] = None, label: str = "",
             device="cpu") -> AnalogState:
        kh, kw = _pair(kernel)
        w, maps, seed = core_linear.init(key, in_channels * kh * kw,
                                         out_channels, cfg, bias=bias,
                                         init_scale=init_scale,
                                         device=device)
        spec = ConvSpec(kernel=(kh, kw), stride=_pair(stride),
                        padding=_freeze_padding(padding),
                        dilation=_pair(dilation))
        meta = AnalogMeta(cfg=cfg, bias=bias, kind="conv", conv=spec,
                          label=label)
        return AnalogState(w, maps, seed, meta)

    @staticmethod
    def apply(state: AnalogState, x: Tensor, key: Optional[prng.Key] = None,
              *, lr: float = 1.0, mode: str = "analog",
              cfg: Optional[RPUConfig] = None, padding=None) -> Tensor:
        spec = state.meta.conv
        cfg = state.meta.cfg if cfg is None else cfg
        padding = spec.padding if padding is None else padding
        if mode != "digital" and key is None:
            raise ValueError(
                "analog reads draw physical noise: pass a PRNG key (or "
                "mode='digital' for key-free FP eval)")
        return core_conv.apply(state.w, x, key, cfg, lr, kernel=spec.kernel,
                               stride=spec.stride, padding=padding,
                               dilation=spec.dilation, bias=state.meta.bias,
                               mode=mode, maps=state.maps, seed=state.seed)
