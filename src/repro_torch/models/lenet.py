"""The paper's MNIST CNN (LeNet-5-like) on RPU tiles.

conv 5x5x16 + tanh + maxpool 2x2 -> conv 5x5x32 + tanh + maxpool 2x2 ->
flatten (512) -> FC 128 tanh -> FC 10 softmax.  The trainable parameters
(biases included) live in four crossbar tiles:

    K1: 16 x 26   (5*5*1  + 1)     K2: 32 x 401  (5*5*16 + 1)
    W3: 128 x 513 (512 + 1)        W4: 10 x 129  (128 + 1)

Per-layer device configs resolve through an
:class:`~repro_torch.analog.policy.AnalogPolicy` over the layer names
(``"K2=k2_multi_device,*=managed"``: the paper's 13-device K2, 416 x 401).
A layer the policy leaves digital runs the exact FP path.  Images are NHWC,
as in the JAX package.  The JAX package's deprecated ``layer_cfgs`` dict is
not ported: :meth:`LeNetConfig.uniform` builds the exact-name policy that
the JAX package makes of it (every rule labelled by its layer).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analog.modules import AnalogConv2d, AnalogLinear, AnalogState
from repro_torch.analog.policy import AnalogPolicy
from repro_torch.core import conv_mapping
from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor
LAYERS = ("K1", "K2", "W3", "W4")
Padding = Union[str, Sequence[Tuple[int, int]]]


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    mode: str = "analog"                     # 'analog' | 'digital'
    lr: float = 0.01                         # the paper's eta
    policy: Optional[AnalogPolicy] = None    # None: RPUConfig() everywhere
    # K1/K2 padding: "VALID" (the paper), "SAME" or explicit
    # ((top, bottom), (left, right)) pairs; W3's fan-in follows from it
    conv_padding: Padding = "VALID"

    def resolved(self, layer: str) -> Optional[RPUConfig]:
        """Device config of one tile; None means the layer is digital."""
        if self.policy is None:
            return RPUConfig()
        return self.policy.resolve(layer)

    def cfg(self, layer: str) -> RPUConfig:
        """The tile's config (a default one for a digital layer, whose
        state still has a device population)."""
        r = self.resolved(layer)
        return r if r is not None else RPUConfig()

    def layer_mode(self, layer: str) -> str:
        if self.mode == "digital" or self.resolved(layer) is None:
            return "digital"
        return self.mode

    def label(self, layer: str) -> str:
        return layer if self.policy is None else self.policy.label_for(layer)

    @staticmethod
    def uniform(cfg: RPUConfig, mode: str = "analog",
                lr: float = 0.01) -> "LeNetConfig":
        """One device config on every tile, as exact-name rules."""
        return LeNetConfig(mode=mode, lr=lr, policy=AnalogPolicy.exact(
            {layer: cfg for layer in LAYERS}))

    @staticmethod
    def from_policy(policy: AnalogPolicy, mode: str = "analog",
                    lr: float = 0.01,
                    conv_padding: Padding = "VALID") -> "LeNetConfig":
        return LeNetConfig(mode=mode, lr=lr, policy=policy,
                           conv_padding=conv_padding)

    def replace_layer(self, layer: str, cfg: RPUConfig) -> "LeNetConfig":
        """``cfg`` on ``layer``: a rule in front of the policy."""
        policy = (self.policy if self.policy is not None
                  else AnalogPolicy.exact({n: RPUConfig() for n in LAYERS}))
        return dataclasses.replace(self, policy=policy.prepend(layer, cfg,
                                                               layer))

    def with_stream_chunks(self, update_chunk: Optional[int] = None,
                           conv_stream_chunk: Optional[int] = None
                           ) -> "LeNetConfig":
        """The streaming pipeline on every tile (``RPUConfig.
        with_streaming``): the materialized step's bits under BM off and
        two-phase BM, with bounded live bytes of columns and streams."""
        policy = (self.policy if self.policy is not None
                  else AnalogPolicy.exact({n: RPUConfig() for n in LAYERS}))
        return dataclasses.replace(self, policy=policy.map_configs(
            lambda c: c.with_streaming(update_chunk, conv_stream_chunk)))


def _pooled_conv_shape(hw: Tuple[int, int], in_c: int, kernel: int,
                       padding: Padding) -> Tuple[int, int]:
    """(H, W) after one conv (stride 1) + 2x2/2 maxpool."""
    g = conv_mapping.conv_geometry((1, hw[0], hw[1], in_c), kernel,
                                   padding=padding)
    if g.oh % 2 or g.ow % 2:
        raise ValueError(
            f"conv output {g.oh}x{g.ow} (padding {padding!r}) is not "
            "2x2-poolable; pick a padding that yields even dims")
    return g.oh // 2, g.ow // 2


def feature_sizes(cfg: LeNetConfig, hw: Tuple[int, int] = (28, 28)
                  ) -> Tuple[Tuple[int, int], Tuple[int, int], int]:
    """Post-pool spatial dims after K1 and K2, and the W3 fan-in."""
    p1 = _pooled_conv_shape(hw, 1, 5, cfg.conv_padding)
    p2 = _pooled_conv_shape(p1, 16, 5, cfg.conv_padding)
    return p1, p2, p2[0] * p2[1] * 32


def init(key: prng.Key, cfg: LeNetConfig, *, device="cpu"
         ) -> Dict[str, AnalogState]:
    """The four tiles from ``key`` (the JAX package's weights and device
    maps from the same key)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    _, _, flat = feature_sizes(cfg)
    kw = dict(device=device)
    pad = cfg.conv_padding
    return {
        "K1": AnalogConv2d.init(k1, 1, 16, 5, cfg.cfg("K1"), padding=pad,
                                label=cfg.label("K1"), **kw),
        "K2": AnalogConv2d.init(k2, 16, 32, 5, cfg.cfg("K2"), padding=pad,
                                label=cfg.label("K2"), **kw),
        "W3": AnalogLinear.init(k3, flat, 128, cfg.cfg("W3"),
                                label=cfg.label("W3"), **kw),
        "W4": AnalogLinear.init(k4, 128, 10, cfg.cfg("W4"),
                                label=cfg.label("W4"), **kw),
    }


def _maxpool2(x: Tensor) -> Tensor:
    b, h, w, c = x.shape
    return torch.amax(x.reshape(b, h // 2, 2, w // 2, 2, c), dim=(2, 4))


def apply(params: Dict[str, AnalogState], images: Tensor,
          key: Optional[prng.Key], cfg: LeNetConfig) -> Tensor:
    """images (B, 28, 28, 1) -> logits (B, 10).  ``key`` seeds the analog
    read and update noise (None only in digital mode)."""
    if key is None:
        if cfg.mode != "digital":
            raise ValueError("analog mode requires a PRNG key")
        key = prng.key(0)
    ks = prng.split(key, 4)
    lr = cfg.lr
    h = AnalogConv2d.apply(params["K1"], images, ks[0], lr=lr,
                           mode=cfg.layer_mode("K1"), cfg=cfg.cfg("K1"),
                           padding=cfg.conv_padding)
    h = _maxpool2(torch.tanh(h))                     # (B, 12, 12, 16)
    h = AnalogConv2d.apply(params["K2"], h, ks[1], lr=lr,
                           mode=cfg.layer_mode("K2"), cfg=cfg.cfg("K2"),
                           padding=cfg.conv_padding)
    h = _maxpool2(torch.tanh(h))                     # (B, 4, 4, 32)
    h = h.reshape(h.shape[0], -1)                    # (B, 512 for VALID)
    h = torch.tanh(AnalogLinear.apply(params["W3"], h, ks[2], lr=lr,
                                      mode=cfg.layer_mode("W3"),
                                      cfg=cfg.cfg("W3")))
    return AnalogLinear.apply(params["W4"], h, ks[3], lr=lr,
                              mode=cfg.layer_mode("W4"), cfg=cfg.cfg("W4"))


def loss_fn(params, images: Tensor, labels: Tensor, key: prng.Key,
            cfg: LeNetConfig) -> Tensor:
    """Summed softmax cross-entropy: each image's error enters the update
    cycle unscaled, as in the paper's minibatch-of-1 training."""
    logp = torch.log_softmax(apply(params, images, key, cfg), dim=-1)
    return -torch.sum(torch.gather(logp, 1, labels.long()[:, None]))


def accuracy(params, images: Tensor, labels: Tensor, key: prng.Key,
             cfg: LeNetConfig) -> Tensor:
    """Noisy-forward accuracy: inference reads the same analog arrays."""
    logits = apply(params, images, key, cfg)
    return torch.mean((torch.argmax(logits, -1) == labels).float())
