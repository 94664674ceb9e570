"""Plain-PyTorch oracles for the read kernels under the tile-API signatures
(the references live in ``repro_torch.core.tile``)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tile as _tile
from repro_torch.core.device import RPUConfig
from repro_torch.utils import prng


def noisy_mvm_ref(w: torch.Tensor, x: torch.Tensor, key: prng.Key,
                  cfg: RPUConfig, *, transpose: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the ``noisy_mvm`` kernel (same counter layout)."""
    return _tile.analog_mvm_reference(w, x, key, cfg, transpose=transpose)


def managed_mvm_ref(w: torch.Tensor, x: torch.Tensor, key: prng.Key,
                    cfg: RPUConfig, *, transpose: bool = False,
                    backward: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the ``managed_mvm`` kernel on physical output channels
    (apply ``tile._replica_mean`` to compare with the kernel's average)."""
    return _tile.managed_mvm_reference(w, x, key, cfg, transpose=transpose,
                                       backward=backward)
