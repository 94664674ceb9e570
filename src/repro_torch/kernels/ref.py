"""Plain-PyTorch oracles for the kernels under the tile-API signatures (the
read references live in ``repro_torch.core.tile``), plus a standalone
``pulse_update_ref`` with the argument contract of the fused update."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tile as _tile
from repro_torch.core import update as _update
from repro_torch.core.device import DeviceMaps, RPUConfig
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


def pulse_update_ref(w: torch.Tensor, dw_up: torch.Tensor,
                     dw_dn: torch.Tensor, bound: torch.Tensor,
                     streams_rows: torch.Tensor, streams_cols: torch.Tensor,
                     key: prng.Key, ctoc: float) -> torch.Tensor:
    """Oracle for the fused ``pulse_update`` kernel: the update cycle's own
    counts and finalize (maps, ctoc noise drawn from ``key``, bound clip)."""
    count_up, count_dn = _update.coincidence_counts(streams_rows,
                                                    streams_cols)
    return _update.finalize_counts(w, DeviceMaps(dw_up, dw_dn, bound),
                                   count_up, count_dn, key,
                                   RPUConfig(dw_min_ctoc=ctoc))
