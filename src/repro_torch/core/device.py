"""RPU device configuration (Table 1 of Gokmen, Onen & Haensch 2017) and the
paper's named model variants.

``RPUConfig`` keeps the JAX package's field names and defaults, so policy
specs such as ``lm_managed:use_pallas=true:bm_mode=two_phase`` resolve to
the same fields in both packages.  In this package ``use_pallas`` routes the
reads through the hand-written CUDA kernels (``repro_torch/kernels``).

The forward read cycle reads no device maps, so map sampling
(``sample_device_maps``) is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RPUConfig:
    """All analog-hardware parameters of the RPU-baseline model (Table 1)
    plus the digitally-programmable management techniques.  Defaults
    reproduce the paper's RPU-baseline exactly."""

    # --- update (stochastic pulse) parameters -------------------------------
    bl: int = 10                       # stochastic bit-stream length BL
    dw_min: float = 0.001              # mean single-coincidence weight change
    dw_min_dtod: float = 0.3           # device-to-device variation of dw_min
    dw_min_ctoc: float = 0.3           # cycle-to-cycle variation of dw_min
    imbalance_dtod: float = 0.02       # device-to-device var. of dw+/dw- ratio
    # --- weight bounds (conductance saturation) -----------------------------
    w_bound: float = 0.6               # mean |w_ij| bound
    w_bound_dtod: float = 0.3          # device-to-device variation of the bound
    # --- analog MVM (forward/backward read) ---------------------------------
    read_noise: float = 0.06           # additive Gaussian sigma on MVM results
    noise_forward: bool = True         # apply read noise in the forward cycle
    noise_backward: bool = True        # apply read noise in the backward cycle
    out_bound: float = 12.0            # |alpha| signal saturation of the integrator
    # --- digitally-programmable management techniques ------------------------
    noise_management: bool = False     # NM, Eq. (3)
    nm_forward: bool = False           # NM also on forward reads
    bound_management: bool = False     # BM, Eq. (4)
    bm_max_iters: int = 10             # effective bound becomes 2^n * alpha
    bm_mode: str = "iterative"         # 'iterative' (paper) | 'two_phase'
    update_management: bool = False    # UM
    update_bl_management: bool = False # reserved: dynamic BL
    # --- multi-device mapping (variability reduction) ------------------------
    devices_per_weight: int = 1        # #_d physical devices per logical weight
    # --- physical array-size limit (Discussion: max 4096x4096) --------------
    max_array_rows: int = 4096
    max_array_cols: int = 4096
    # --- sharded tile grid / streaming chunks (not in this package yet) -----
    tile_grid: Optional[Tuple[int, int]] = None
    update_chunk: Optional[int] = None
    conv_stream_chunk: Optional[int] = None
    fuse_bwd_update: bool = False
    # --- implementation switches ---------------------------------------------
    seeded_maps: bool = False          # regenerate device maps from the seed
    dtype: torch.dtype = torch.float32 # simulation dtype for weights / MVMs
    use_pallas: bool = False           # route reads through the CUDA kernels
    fast_rng: bool = True              # counter-hash RNG for read noise

    def without_variations(self) -> "RPUConfig":
        """Eliminate device-to-device & cycle-to-cycle variations."""
        return dataclasses.replace(
            self, dw_min_dtod=0.0, dw_min_ctoc=0.0, imbalance_dtod=0.0,
            w_bound_dtod=0.0)

    def without_imbalance(self) -> "RPUConfig":
        return dataclasses.replace(self, imbalance_dtod=0.0)

    def without_read_noise(self) -> "RPUConfig":
        return dataclasses.replace(self, read_noise=0.0)

    def without_out_bound(self) -> "RPUConfig":
        return dataclasses.replace(self, out_bound=float("inf"))

    def with_management(self, nm: bool = True, bm: bool = True,
                        um: bool = False, bl: Optional[int] = None
                        ) -> "RPUConfig":
        kw = dict(noise_management=nm, bound_management=bm,
                  update_management=um)
        if bl is not None:
            kw["bl"] = bl
        return dataclasses.replace(self, **kw)

    def normalized_for_lm(self) -> "RPUConfig":
        """LM dense tiles simulate in float32 with seeded device maps."""
        return dataclasses.replace(self, dtype=torch.float32,
                                   seeded_maps=True)


def rpu_baseline() -> RPUConfig:
    """Table 1 verbatim: BL=10, no management."""
    return RPUConfig()


def rpu_nm_bm() -> RPUConfig:
    """RPU baseline + noise & bound management (Fig. 6)."""
    return rpu_baseline().with_management(nm=True, bm=True)


def rpu_nm_bm_um_bl1() -> RPUConfig:
    """+ update management with BL=1 (Fig. 6)."""
    return rpu_baseline().with_management(nm=True, bm=True, um=True, bl=1)


def rpu_full(devices_per_weight: int = 13) -> RPUConfig:
    """+ multi-device mapping (paper: 13x on K2)."""
    return dataclasses.replace(
        rpu_nm_bm_um_bl1(), devices_per_weight=devices_per_weight)
