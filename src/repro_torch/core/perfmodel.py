"""RPU-chip analytical performance model (paper Discussion + Table 2).

On conventional hardware the time per image is ``total_MACs / throughput``;
on an RPU accelerator with pipelined arrays it is dominated by the *largest
weight-reuse factor*: ``t_image ~ max_over_layers(ws_l * t_meas_l)`` because
each of the ``ws`` im2col columns is a serial O(1) vector operation on the
layer's array, and layers overlap in a pipeline.

Array timing follows the paper's bimodal design: a 4096x4096 array integrates
for ``t_meas = 80 ns`` (thermal-noise limited); a small 512x512 array can run
at ``t_meas = 10 ns``.  A layer can also be *split* across ``n_arrays``
(image-partitioning), dividing its weight-reuse factor.

Pure arithmetic, the JAX package's ``core/perfmodel.py`` value for value.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One mapped layer: array dims (rows x cols) and weight sharing factor."""
    name: str
    rows: int          # M (output channels / neurons)
    cols: int          # k^2 d (+1)
    weight_sharing: int  # ws = number of serial vector ops per image
    n_arrays: int = 1    # image-partitioned replicas (Discussion)

    @property
    def macs(self) -> int:
        return self.rows * self.cols * self.weight_sharing

    @property
    def effective_ws(self) -> float:
        return self.weight_sharing / self.n_arrays


@dataclasses.dataclass(frozen=True)
class RPUChipSpec:
    """RPU chip timing (paper: 80 ns large arrays; 10 ns small 512x512).

    ``bimodal=False`` is the paper's baseline (every layer on a 4096x4096
    80 ns array); ``bimodal=True`` is the Discussion's proposed design where
    layers fitting a 512x512 array run at 10 ns.
    """
    t_meas_large: float = 80e-9
    t_meas_small: float = 10e-9
    small_array_dim: int = 512
    large_array_dim: int = 4096
    bimodal: bool = False

    def t_meas(self, rows: int, cols: int) -> float:
        if self.bimodal and max(rows, cols) <= self.small_array_dim:
            return self.t_meas_small
        return self.t_meas_large


def layer_time(layer: LayerSpec, chip: RPUChipSpec) -> float:
    """Per-image time of this layer's array: effective ws x t_meas."""
    return layer.effective_ws * chip.t_meas(layer.rows, layer.cols)


def image_time_rpu(layers: Sequence[LayerSpec], chip: RPUChipSpec
                   ) -> Tuple[float, str]:
    """Pipelined RPU chip: time per image = the slowest stage; returns
    ``(time, bottleneck layer)``."""
    times = [(layer_time(l, chip), l.name) for l in layers]
    t, name = max(times)
    return t, name


def image_time_conventional(layers: Sequence[LayerSpec],
                            throughput_macs: float) -> float:
    """Compute-bound conventional chip: total MACs / throughput."""
    return sum(l.macs for l in layers) / throughput_macs


def alexnet_layers() -> List[LayerSpec]:
    """Table 2 verbatim (weights of both GPU halves in a single array)."""
    return [
        LayerSpec("K1", 96, 363, 3025),
        LayerSpec("K2", 256, 2400, 729),
        LayerSpec("K3", 384, 2304, 169),
        LayerSpec("K4", 384, 3456, 169),
        LayerSpec("K5", 256, 3456, 169),
        LayerSpec("W6", 4096, 9216, 1),
        LayerSpec("W7", 4096, 4096, 1),
        LayerSpec("W8", 1000, 4096, 1),
    ]


def lenet_layers() -> List[LayerSpec]:
    """The paper's MNIST CNN: K1 16x26 ws=576, K2 32x401 ws=64, W3, W4."""
    return [
        LayerSpec("K1", 16, 26, 24 * 24),
        LayerSpec("K2", 32, 401, 8 * 8),
        LayerSpec("W3", 128, 513, 1),
        LayerSpec("W4", 10, 129, 1),
    ]


def split_bottleneck(layers: Sequence[LayerSpec], n_arrays: int,
                     chip: Optional[RPUChipSpec] = None) -> List[LayerSpec]:
    """Discussion: allocate n arrays to the bottleneck layer (ws /= n)."""
    _, name = image_time_rpu(layers, chip or RPUChipSpec())
    return [dataclasses.replace(l, n_arrays=n_arrays) if l.name == name else l
            for l in layers]
