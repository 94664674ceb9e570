"""RPU device configuration (Table 1 of Gokmen, Onen & Haensch 2017) and the
paper's named model variants.

``RPUConfig`` keeps the JAX package's field names and defaults, so policy
specs such as ``lm_managed:use_pallas=true:bm_mode=two_phase`` resolve to
the same fields in both packages.  In this package ``use_pallas`` routes the
reads through the hand-written CUDA kernels (``repro_torch/kernels``).

Device maps (:class:`DeviceMaps`: per-device ``dw_up``, ``dw_dn`` and
weight bound) are sampled by :func:`sample_device_maps` from the threefry
draws of ``utils/prng.py``.  They agree with the JAX package's maps to
within 1e-6 of the map's mean, and about 99% of them bitwise: the normal
draws differ by an ulp where numpy's ``log1p`` and XLA's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.utils import prng


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
    # --- sub-tile grid (core/tile_grid.py); streaming chunks ---------------
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

    def with_tile_grid(self, rows: int, cols: int) -> "RPUConfig":
        """Decompose the tile into a (rows x cols) sub-tile grid
        (``core/tile_grid.py``)."""
        if rows < 1 or cols < 1:
            raise ValueError(
                f"tile_grid must be >= (1, 1), got {(rows, cols)}")
        return dataclasses.replace(self, tile_grid=(rows, cols))

    def with_streaming(self, update_chunk: Optional[int] = None,
                       conv_stream_chunk: Optional[int] = None
                       ) -> "RPUConfig":
        """Chunk the update cycle's pulse streams (``update_chunk`` rows of
        the flattened batch at a time) and/or the conv position columns
        (``conv_stream_chunk``).  A field left None keeps its value.

        Chunked training gives the materialized step's bits under the
        fixed-latency BM modes (off, two-phase); iterative BM's retries
        become chunk-local, the same in distribution and bit-exact without
        read noise.  Requires ``fast_rng``: a chunk's draws are the
        counter-offset draws of its rows."""
        for name, v in (("update_chunk", update_chunk),
                        ("conv_stream_chunk", conv_stream_chunk)):
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if (update_chunk or conv_stream_chunk) and not self.fast_rng:
            raise ValueError(
                "streaming chunks require fast_rng=True (threefry draws "
                "cannot be counter-offset for chunk bit-parity)")
        return dataclasses.replace(
            self,
            update_chunk=(self.update_chunk if update_chunk is None
                          else update_chunk),
            conv_stream_chunk=(self.conv_stream_chunk
                               if conv_stream_chunk is None
                               else conv_stream_chunk))

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


# ---------------------------------------------------------------------------
# Device map sampling
# ---------------------------------------------------------------------------

class DeviceMaps:
    """Per-physical-device parameter maps of one crossbar tile, each
    ``(rows_phys, cols)`` with ``rows_phys = #_d * rows_logical``."""

    __slots__ = ("dw_up", "dw_dn", "bound")

    def __init__(self, dw_up: torch.Tensor, dw_dn: torch.Tensor,
                 bound: torch.Tensor):
        self.dw_up = dw_up
        self.dw_dn = dw_dn
        self.bound = bound

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.dw_up.shape)


def sample_device_maps(key: prng.Key, rows_phys: int, cols: int,
                       cfg: RPUConfig, *, device="cpu") -> DeviceMaps:
    """Sample the fabrication-time device population of a tile: ``dw_min``
    with ``dw_min_dtod`` relative spread (floored at 1% of the mean), the
    up/down ratio ``r`` with ``imbalance_dtod`` spread (clipped to [0.5, 2],
    applied as ``dw * sqrt(r)`` and ``dw / sqrt(r)``), and the weight bound
    with ``w_bound_dtod`` spread (floored at 10% of the mean)."""
    k_dw, k_imb, k_bound = prng.split(key, 3)
    shape = (rows_phys, cols)

    def normal(k):
        return prng.normal(k, shape, device=device).to(cfg.dtype)

    dw = cfg.dw_min * (1.0 + cfg.dw_min_dtod * normal(k_dw))
    dw = torch.clamp_min(dw, 0.01 * cfg.dw_min)
    r = torch.clamp(1.0 + cfg.imbalance_dtod * normal(k_imb), 0.5, 2.0)
    sqrt_r = torch.sqrt(r)
    bound = cfg.w_bound * (1.0 + cfg.w_bound_dtod * normal(k_bound))
    bound = torch.clamp_min(bound, 0.1 * cfg.w_bound)
    return DeviceMaps(dw_up=dw * sqrt_r, dw_dn=dw / sqrt_r, bound=bound)


def seeded_device_maps(seed_key: prng.Key, rows_phys: int, cols: int,
                       cfg: RPUConfig, *, device="cpu") -> DeviceMaps:
    """Regenerate a tile's fixed device population from its seed (the same
    draw as :func:`sample_device_maps`, recomputed instead of stored)."""
    return sample_device_maps(seed_key, rows_phys, cols, cfg, device=device)
