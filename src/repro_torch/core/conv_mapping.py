"""Conv -> crossbar mapping: a conv layer with kernels ``(M, kh, kw, C)`` is
the parameter matrix ``K (M, C*kh*kw [+1 bias])`` read against the im2col
columns of its input, one column per output position:

    forward   Y = K X             (one managed read per position column)
    backward  Z = K^T D           (then the digital col2im scatter-add)
    update    K <- K + eta D X^T  (pulse updates over every column)

Feature order is channel-major (``c * kh*kw + ih * kw + iw``), bias last.
The whole batch x positions axis is one chunk (the JAX package's
``conv_stream_chunk=None``); the streaming chunks are not ported yet.
Under ``cfg.use_pallas`` the forward read is the implicit-im2col kernel
(``kernels/conv_mvm.py``) and, with ``cfg.fuse_bwd_update``, the backward
read and the update are one kernel launch (``kernels/bwd_update_mvm.py``);
otherwise the columns are gathered here and go through the dense tile
cycles.  A tile with a sub-tile grid (``cfg.tile_grid``) is never eligible
for either kernel: its columns take the dense cycles, which run on the grid
(``core/tile_grid.py``).  ``col2im_add`` applies the taps in descending
order, the JAX package's per-pixel accumulation order.

Layouts follow the JAX package: activations are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import analog_linear
from repro_torch.core import management
from repro_torch.core import tile as tile_lib
from repro_torch.core import update as update_lib
from repro_torch.core.device import DeviceMaps, RPUConfig
from repro_torch.utils import prng

Tensor = torch.Tensor
IntPair = Union[int, Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@dataclasses.dataclass(frozen=True)
class ConvGeom:
    """Resolved static geometry of one conv application; ``h``/``w`` are
    the padded input dims."""

    kh: int
    kw: int
    sh: int
    sw: int
    dh: int
    dw: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]   # ((top, bot), (l, r))
    b: int
    h: int
    w: int
    c: int
    oh: int
    ow: int
    bias: bool

    @property
    def positions(self) -> int:
        return self.b * self.oh * self.ow

    @property
    def features(self) -> int:
        return self.c * self.kh * self.kw

    @property
    def cols(self) -> int:
        return self.features + (1 if self.bias else 0)

    @property
    def taps(self):
        """(ih, iw) kernel taps in ascending (row-major) order."""
        return [(ih, iw) for ih in range(self.kh) for iw in range(self.kw)]

    def tap_slice(self, xpad: Tensor, ih: int, iw: int) -> Tensor:
        """The (B, OH, OW, C) strided view of the padded volume feeding tap
        ``(ih, iw)``."""
        r0, c0 = ih * self.dh, iw * self.dw
        return xpad[:, r0:r0 + (self.oh - 1) * self.sh + 1:self.sh,
                    c0:c0 + (self.ow - 1) * self.sw + 1:self.sw, :]


def conv_geometry(x_shape: Tuple[int, ...], kernel: IntPair,
                  stride: IntPair = 1, padding: Padding = "VALID",
                  dilation: IntPair = 1, bias: bool = True) -> ConvGeom:
    """Resolve the static geometry (the JAX package's padding arithmetic)."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    b, h, w, c = x_shape
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    if not isinstance(padding, str):
        (pt, pb), (pl, pr) = ((int(a), int(b_)) for a, b_ in padding)
    elif padding.upper() == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        ph = max(0, (oh - 1) * sh + ekh - h)
        pw = max(0, (ow - 1) * sw + ekw - w)
        pt, pb, pl, pr = ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    elif padding.upper() == "VALID":
        pt = pb = pl = pr = 0
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    hp, wp = h + pt + pb, w + pl + pr
    oh, ow = (hp - ekh) // sh + 1, (wp - ekw) // sw + 1
    return ConvGeom(kh=kh, kw=kw, sh=sh, sw=sw, dh=dh, dw=dw,
                    pads=((pt, pb), (pl, pr)), b=b, h=hp, w=wp, c=c,
                    oh=oh, ow=ow, bias=bias)


def _pad_volume(x: Tensor, geom: ConvGeom) -> Tensor:
    (pt, pb), (pl, pr) = geom.pads
    if pt == pb == pl == pr == 0:
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def _unpad(xbar: Tensor, geom: ConvGeom) -> Tensor:
    (pt, pb), (pl, pr) = geom.pads
    return xbar[:, pt:geom.h - pb, pl:geom.w - pr, :]


def _patches(xpad: Tensor, geom: ConvGeom) -> Tensor:
    """Patch rows ``(B, OH, OW, C*kh*kw)``, channel-major, from the
    ``kh*kw`` strided tap slices (pure data movement)."""
    taps = [geom.tap_slice(xpad, ih, iw) for ih, iw in geom.taps]
    p = torch.stack(taps, dim=-1)                    # (B, OH, OW, C, kk)
    return p.reshape(geom.b, geom.oh, geom.ow, geom.features)


def gather_columns(xpad: Tensor, geom: ConvGeom) -> Tensor:
    """The im2col column matrix ``(positions, cols)`` of the padded volume,
    bias ones appended."""
    cols = _patches(xpad, geom).reshape(geom.positions, geom.features)
    if geom.bias:
        ones = torch.ones(geom.positions, 1, dtype=cols.dtype,
                          device=cols.device)
        cols = torch.cat([cols, ones], dim=1)
    return cols


def im2col(x: Tensor, kernel: IntPair, stride: IntPair = 1,
           padding: Padding = "VALID", dilation: IntPair = 1) -> Tensor:
    """Convolution patches ``(B, H', W', C*kh*kw)`` (channel-major)."""
    geom = conv_geometry(tuple(x.shape), kernel, stride, padding, dilation,
                         bias=False)
    return _patches(_pad_volume(x, geom), geom)


def window_absmax(xpad: Tensor, geom: ConvGeom) -> Tensor:
    """Per-position ``max|patch row|`` ``(B, OH, OW)`` as a running max
    over the tap slices (order-exact)."""
    m = None
    for ih, iw in geom.taps:
        s = torch.amax(torch.abs(geom.tap_slice(xpad, ih, iw)), dim=-1)
        m = s if m is None else torch.maximum(m, s)
    return m


def col2im_add(z: Tensor, geom: ConvGeom, xbar: Tensor) -> Tensor:
    """Scatter-add transpose-read columns ``(positions, features)`` into the
    padded volume cotangent ``xbar`` (in place), taps in DESCENDING order —
    the JAX package's per-pixel accumulation order."""
    z5 = z.reshape(geom.b, geom.oh, geom.ow, geom.c, geom.kh * geom.kw)
    for t in reversed(range(geom.kh * geom.kw)):
        ih, iw = divmod(t, geom.kw)
        geom.tap_slice(xbar, ih, iw).add_(z5[..., t])
    return xbar


def _conv_nm_scale(xpad: Tensor, geom: ConvGeom) -> Tensor:
    """Per-position NM scale ``(positions, 1)``: ``management.nm_scale`` of
    the column rows from the window max (the bias adds a constant 1)."""
    s = window_absmax(xpad, geom).reshape(geom.positions, 1)
    if geom.bias:
        return torch.clamp_min(s, 1.0)
    return torch.where(s > management._EPS, s, torch.ones_like(s))


def _um_maxima(cfg: RPUConfig, xpad: Tensor, geom: ConvGeom, g2: Tensor):
    """``(max|x|, max|d|)`` over the (never gathered) columns and the
    update's row drivers ``-g``, under update management; else None."""
    if not cfg.update_management:
        return None
    x_max = torch.amax(window_absmax(xpad, geom))
    if geom.bias:
        x_max = torch.clamp_min(x_max, 1.0)
    return x_max, torch.amax(torch.abs(g2))


def _stream_forward(cfg: RPUConfig, geom: ConvGeom, w: Tensor, x: Tensor,
                    k_f: prng.Key) -> Tensor:
    """Forward cycle: managed reads of every position column."""
    from repro_torch.kernels import conv_mvm
    xpad = _pad_volume(x, geom)
    if conv_mvm.conv_kernel_eligible(cfg, geom, w.shape):
        from repro_torch.kernels import ops as kops
        use_nm = cfg.noise_management and cfg.nm_forward
        nm_s = (_conv_nm_scale(xpad, geom) if use_nm
                else torch.ones(geom.positions, 1, dtype=x.dtype,
                                device=x.device))
        y2, _ = kops.conv_managed_mvm(w, xpad, geom, nm_s, k_f, cfg)
    else:
        y2 = tile_lib.tile_forward(w, gather_columns(xpad, geom), k_f, cfg)
    return y2.reshape(geom.b, geom.oh, geom.ow, -1)


def _col2im(z: Tensor, geom: ConvGeom) -> Tensor:
    xbar = torch.zeros(geom.b, geom.h, geom.w, geom.c, dtype=z.dtype,
                       device=z.device)
    return _unpad(col2im_add(z[:, :geom.features], geom, xbar), geom)


def _stream_backward(cfg: RPUConfig, geom: ConvGeom, w: Tensor, g: Tensor,
                     k_b: prng.Key) -> Tensor:
    """Backward cycle: transpose reads of the position errors + col2im."""
    out_f = w.shape[0] // cfg.devices_per_weight
    z = tile_lib.tile_backward(w, g.reshape(geom.positions, out_f), k_b, cfg)
    return _col2im(z, geom)


def _stream_pulse_w_bar(cfg: RPUConfig, geom: ConvGeom, w: Tensor,
                        maps: DeviceMaps, x: Tensor, g: Tensor,
                        k_u: prng.Key, lr: float) -> Tensor:
    """Update cycle over the columns and the errors ``-g``:
    ``w_bar = w - clip(w + DW_pulse(cols, -g))``."""
    xpad = _pad_volume(x, geom)
    d = cfg.devices_per_weight
    g2 = g.reshape(geom.positions, w.shape[0] // d)
    new_w = update_lib.pulse_update_streamed(
        w, maps, gather_columns(xpad, geom),
        tile_lib.replicate_delta(-g2, d), k_u, cfg, lr,
        um_maxima=_um_maxima(cfg, xpad, geom, g2))
    return w - new_w


def _fused_bwd_update(cfg: RPUConfig, geom: ConvGeom, w: Tensor,
                      maps: DeviceMaps, x: Tensor, g: Tensor, k_b: prng.Key,
                      k_u: prng.Key, lr: float) -> Tuple[Tensor, Tensor]:
    """Backward and update cycles in one fused kernel launch: the same
    result as :func:`_stream_backward` + :func:`_stream_pulse_w_bar`."""
    from repro_torch.kernels import ops as kops

    xpad = _pad_volume(x, geom)
    d = cfg.devices_per_weight
    g2 = g.reshape(geom.positions, w.shape[0] // d)
    delta_rep = tile_lib.replicate_delta(g2, d, rows_phys=w.shape[0])
    k_a, k_b2, k_c = prng.split(k_u, 3)
    z, _sat, count_up, count_dn = kops.conv_bwd_update_mvm(
        w, xpad, delta_rep, geom, k_b, k_a, k_b2, cfg, lr,
        um_maxima=_um_maxima(cfg, xpad, geom, g2))
    if d > 1:
        z = tile_lib.div_replicas(z, d)
    new_w = update_lib.finalize_counts(w, maps, count_up, count_dn, k_c, cfg)
    return _col2im(z, geom), w - new_w


class _ConvCycles(torch.autograd.Function):
    """The three RPU cycles of a conv layer: the forward read under
    ``k_f``; the backward returns ``x_bar`` and ``w_bar = w - clip(w + DW)``
    (fused into one launch when eligible)."""

    @staticmethod
    def forward(ctx, cfg, geom, w, x, key, lr, maps, seed):
        ctx.save_for_backward(w, x)
        ctx.cfg, ctx.geom, ctx.key, ctx.lr = cfg, geom, key, lr
        ctx.maps, ctx.seed = maps, seed
        return _stream_forward(cfg, geom, w, x, analog_linear.forward_key(key))

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        cfg, geom, lr = ctx.cfg, ctx.geom, ctx.lr
        _, k_b, k_u = analog_linear.split3(ctx.key)
        g = g.contiguous()
        maps = tile_lib.tile_maps(w, ctx.maps, ctx.seed, cfg)
        from repro_torch.kernels.bwd_update_mvm import bwd_update_eligible
        if bwd_update_eligible(cfg, w.shape):
            x_bar, w_bar = _fused_bwd_update(cfg, geom, w, maps, x, g, k_b,
                                             k_u, lr)
        else:
            x_bar = _stream_backward(cfg, geom, w, g, k_b)
            w_bar = _stream_pulse_w_bar(cfg, geom, w, maps, x, g, k_u, lr)
        return None, None, w_bar, x_bar, None, None, None, None


def apply(w: Tensor, x: Tensor, key: Optional[prng.Key], cfg: RPUConfig,
          lr: float = 1.0, *, kernel: IntPair, stride: IntPair = 1,
          padding: Padding = "VALID", dilation: IntPair = 1,
          bias: bool = True, mode: str = "analog",
          maps: Optional[DeviceMaps] = None,
          seed: Optional[prng.Key] = None) -> Tensor:
    """Analog 2-D convolution ``(B, H, W, C) -> (B, H', W', M)``.  Analog
    mode runs the three RPU cycles over every position column (maps stored,
    or regenerated from ``seed`` when ``maps`` is None or the config has
    seeded maps); digital mode is im2col + the FP dense layer."""
    if mode == "digital":
        patches = im2col(x, kernel, stride, padding, dilation)
        return analog_linear.apply(w, patches, key, cfg, lr, bias=bias,
                                   mode=mode)
    tile_lib.check_supported(cfg)
    geom = conv_geometry(tuple(x.shape), kernel, stride, padding, dilation,
                         bias)
    if cfg.seeded_maps:
        maps = None
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _ConvCycles.apply(cfg, geom, w, x, key, float(lr), maps, seed)
    return _stream_forward(cfg, geom, w, x, analog_linear.forward_key(key))
