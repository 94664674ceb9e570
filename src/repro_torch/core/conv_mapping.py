"""Conv -> crossbar mapping, streamed: a conv layer with kernels ``(M, kh,
kw, C)`` is the parameter matrix ``K (M, C*kh*kw [+1 bias])`` read against
the im2col columns of its input, one column per output position:

    forward   Y = K X             (one managed read per position column)
    backward  Z = K^T D           (then the digital col2im scatter-add)
    update    K <- K + eta D X^T  (pulse updates over every column)

Feature order is channel-major (``c * kh*kw + ih * kw + iw``), bias last.
The analog cycles walk the batch x positions axis in chunks of
``cfg.conv_stream_chunk`` columns (None: one chunk, the materialized
path), so only one chunk of columns and of their ``~BL x`` larger pulse
streams is live at a time:

* forward: each chunk is gathered from the activation volume
  (:func:`gather_columns`) and read through ``tile.tile_forward`` at its
  rows' offset in the whole read, so its noise and NM/BM scales are the
  whole read's.  Under ``cfg.use_pallas`` with a fixed-latency BM mode the
  implicit-im2col kernel (``kernels/conv_mvm.py``) reads every column in
  one launch, whatever the chunk.
* backward: each chunk's transpose read scatter-adds into the volume
  cotangent (:func:`col2im_add`) taps in descending order: a pixel's
  contributing positions fall as the tap rises, so ascending chunks of
  descending taps add every pixel's terms in one order whatever the chunk
  size, and chunked and materialized backward cycles agree bit for bit.
* update: each chunk's coincidence counts add exactly to the others'
  (``update.pulse_update_streamed``); maps, ctoc noise and the clip apply
  once at the end.

So for BM off and two-phase BM a chunked step gives the materialized
step's bits.  Under iterative BM each chunk's halve-and-retry loop decides
its retries from its own rows: per-vector scales are the same, results
the same in distribution and bit-exact without read noise.  With
``cfg.fuse_bwd_update`` the backward read and the update are one kernel
launch (``kernels/bwd_update_mvm.py``) over every column, whatever the
chunk, so a fused step with chunks is the fused step.  A tile with a
sub-tile grid (``cfg.tile_grid``) is never eligible for either kernel: its
chunks take the dense cycles, which run on the grid
(``core/tile_grid.py``).  The chunk loops run on the host: a captured step
records one launch per chunk.

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


def _position_indices(geom: ConvGeom, start: int, chunk: int,
                      device) -> Tensor:
    """Flat index, in the padded volume viewed as ``(B*H*W, C)``, of the
    first tap's pixel of each position ``[start, start + chunk)``."""
    p = torch.arange(start, start + chunk, dtype=torch.int64, device=device)
    per_img = geom.oh * geom.ow
    b = p // per_img
    r = p - b * per_img
    return (b * geom.h + (r // geom.ow) * geom.sh) * geom.w + \
        (r % geom.ow) * geom.sw


def _check_chunk(geom: ConvGeom, start: int, chunk: int) -> None:
    if start < 0 or chunk < 1 or start + chunk > geom.positions:
        raise ValueError(f"positions [{start}, {start + chunk}) outside "
                         f"[0, {geom.positions})")


def gather_columns(xpad: Tensor, geom: ConvGeom, start: int,
                   chunk: int) -> Tensor:
    """One chunk of the im2col column matrix, ``(chunk, cols)``: positions
    ``[start, start + chunk)`` of the padded volume, bias ones appended.
    The whole matrix comes from the tap slices; a chunk of it from one
    gather of its rows' pixels (the same values)."""
    _check_chunk(geom, start, chunk)
    if chunk == geom.positions:
        cols = _patches(xpad, geom).reshape(chunk, geom.features)
    else:
        kk = geom.kh * geom.kw
        ih = torch.arange(geom.kh, dtype=torch.int64, device=xpad.device)
        iw = torch.arange(geom.kw, dtype=torch.int64, device=xpad.device)
        taps = (ih[:, None] * (geom.dh * geom.w)
                + iw[None, :] * geom.dw).reshape(kk)
        idx = _position_indices(geom, start, chunk, xpad.device)
        g = xpad.reshape(-1, geom.c).index_select(
            0, (idx[:, None] + taps[None, :]).reshape(-1))
        cols = g.reshape(chunk, kk, geom.c).transpose(1, 2).reshape(
            chunk, geom.features)
    if geom.bias:
        ones = torch.ones(chunk, 1, dtype=cols.dtype, device=cols.device)
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


def col2im_add(z: Tensor, geom: ConvGeom, start: int, chunk: int,
               xbar: Tensor) -> Tensor:
    """Scatter-add one chunk's transpose-read columns ``(chunk, features)``
    (positions ``[start, start + chunk)``) into the padded volume
    cotangent ``xbar`` (in place), taps in DESCENDING order: a pixel's
    contributing positions fall as the tap rises, so chunks in ascending
    order add every pixel's terms in one order whatever the chunk size
    (the JAX package's per-pixel accumulation order).  Within one tap no
    two positions meet at a pixel."""
    _check_chunk(geom, start, chunk)
    kk = geom.kh * geom.kw
    if chunk == geom.positions:
        z5 = z.reshape(geom.b, geom.oh, geom.ow, geom.c, kk)
        for t in reversed(range(kk)):
            ih, iw = divmod(t, geom.kw)
            geom.tap_slice(xbar, ih, iw).add_(z5[..., t])
        return xbar
    z3 = z.reshape(chunk, geom.c, kk)
    idx = _position_indices(geom, start, chunk, z.device)
    flat = xbar.view(-1, geom.c)
    for t in reversed(range(kk)):
        ih, iw = divmod(t, geom.kw)
        flat.index_add_(0, idx + (ih * geom.dh * geom.w + iw * geom.dw),
                        z3[:, :, t])
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


def _chunking(cfg: RPUConfig, geom: ConvGeom) -> int:
    """Positions per chunk under ``cfg.conv_stream_chunk`` (None: one
    chunk of every position)."""
    total = geom.positions
    return max(1, min(cfg.conv_stream_chunk or total, total))


def _chunks(cfg: RPUConfig, geom: ConvGeom):
    return update_lib.chunk_starts(geom.positions, _chunking(cfg, geom))


def _stream_forward(cfg: RPUConfig, geom: ConvGeom, w: Tensor, x: Tensor,
                    k_f: prng.Key) -> Tensor:
    """Forward cycle: managed reads of every position column, in chunks
    (the conv read kernel takes every column in one launch)."""
    from repro_torch.kernels import conv_mvm
    xpad = _pad_volume(x, geom)
    total = geom.positions
    if conv_mvm.conv_kernel_eligible(cfg, geom, w.shape):
        from repro_torch.kernels import ops as kops
        use_nm = cfg.noise_management and cfg.nm_forward
        nm_s = (_conv_nm_scale(xpad, geom) if use_nm
                else torch.ones(total, 1, dtype=x.dtype, device=x.device))
        y2, _ = kops.conv_managed_mvm(w, xpad, geom, nm_s, k_f, cfg)
    else:
        ys = [tile_lib.tile_forward(w, gather_columns(xpad, geom, start, n),
                                    k_f, cfg, row_offset=start,
                                    total_rows=total)
              for start, n in _chunks(cfg, geom)]
        y2 = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y2.reshape(geom.b, geom.oh, geom.ow, -1)


def _new_xbar(geom: ConvGeom, like: Tensor) -> Tensor:
    return torch.zeros(geom.b, geom.h, geom.w, geom.c, dtype=like.dtype,
                       device=like.device)


def _stream_backward(cfg: RPUConfig, geom: ConvGeom, w: Tensor, g: Tensor,
                     k_b: prng.Key) -> Tensor:
    """Backward cycle: transpose reads of the position errors, chunk by
    chunk, each scattered into the volume cotangent (col2im)."""
    total = geom.positions
    g2 = g.reshape(total, w.shape[0] // cfg.devices_per_weight)
    xbar = _new_xbar(geom, g)
    for start, n in _chunks(cfg, geom):
        z = tile_lib.tile_backward(w, g2[start:start + n], k_b, cfg,
                                   row_offset=start, total_rows=total)
        col2im_add(z[:, :geom.features], geom, start, n, xbar)
    return _unpad(xbar, geom)


def _stream_pulse_w_bar(cfg: RPUConfig, geom: ConvGeom, w: Tensor,
                        maps: DeviceMaps, x: Tensor, g: Tensor,
                        k_u: prng.Key, lr: float) -> Tensor:
    """Update cycle over the columns and the errors ``-g``, generated chunk
    by chunk: ``w_bar = w - clip(w + DW_pulse(cols, -g))``."""
    xpad = _pad_volume(x, geom)
    d = cfg.devices_per_weight
    g2 = g.reshape(geom.positions, w.shape[0] // d)

    def get_chunk(src, start, n):
        xp, gg = src
        return (gather_columns(xp, geom, start, n),
                tile_lib.replicate_delta(-gg[start:start + n], d))

    new_w = update_lib.pulse_update_streamed(
        w, maps, (xpad, g2), get_chunk, k_u, cfg, lr,
        total=geom.positions, chunk=_chunking(cfg, geom),
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
    xbar = col2im_add(z[:, :geom.features], geom, 0, geom.positions,
                      _new_xbar(geom, z))
    return _unpad(xbar, geom), w - new_w


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
    if cfg.conv_stream_chunk is not None and not cfg.fast_rng:
        raise ValueError("conv_stream_chunk requires cfg.fast_rng (chunk "
                         "bit-parity needs counter-offset noise)")
    geom = conv_geometry(tuple(x.shape), kernel, stride, padding, dilation,
                         bias)
    if cfg.seeded_maps:
        maps = None
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _ConvCycles.apply(cfg, geom, w, x, key, float(lr), maps, seed)
    return _stream_forward(cfg, geom, w, x, analog_linear.forward_key(key))
