"""Model configuration dataclass (dense decoder family).

Each ``configs/<id>.py`` exports ``CONFIG`` (the published numbers) and
``smoke_config()`` (a reduced same-family config for CPU tests); the
``registry`` resolves ``--arch`` names.  Only the dense family is ported:
MoE, SSM, hybrid and encoder-decoder stacks are not part of this package
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analog.policy import AnalogPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    act_dtype: torch.dtype = torch.bfloat16
    # analog (RPU): dense projections matched by a rule are converted to
    # AnalogState tiles at init (repro_torch.analog.convert)
    analog_policy: Optional[AnalogPolicy] = None

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"only the dense family is ported, got {self.family!r}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)
