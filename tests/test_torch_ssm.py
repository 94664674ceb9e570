"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``, at small sizes in float32.

Inputs are drawn with numpy from a seed; block parameters are the JAX
package's ``ssm.init`` draws, carried across with ``from_jax_params``.

Tolerances:

* ``_causal_conv``: ``CONV_ATOL`` (the same four products summed in the
  same order; XLA may fuse a multiply-add);
* ``_ssd_chunked``, ``forward`` and ``decode``: ``SSD_ATOL`` absolute on
  outputs of magnitude ~1 (float32 reassociation of the chunk einsums);
* ``_seq_dense``: ``ACT_ATOL`` of ``test_torch_recurrent.py`` on the
  analog routes (per-position reads, noise in float32), exact for the
  digital product.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog.modules import AnalogLinear as JLinear
from repro.configs import registry as jregistry
from repro.core import device as jdev
from repro.models import layers as jL
from repro.models import ssm as jS
from repro_torch.analog.convert import from_jax_params
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tS
from repro_torch.utils import prng

from test_torch_recurrent import ACT_ATOL, _numpy_tree

CONV_ATOL = 1e-6
SSD_ATOL = 2e-5
D_IN, HID = 5, 6


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs():
    jcfg = dataclasses.replace(jregistry.get_config("mamba2_130m",
                                                    smoke=True),
                               param_dtype=jnp.float32,
                               act_dtype=jnp.float32)
    tcfg = dataclasses.replace(tregistry.get_config("mamba2_130m",
                                                    smoke=True),
                               param_dtype=torch.float32,
                               act_dtype=torch.float32)
    return jcfg, tcfg


def _block():
    jcfg, tcfg = _cfgs()
    pj, _ = jS.init(jax.random.key(0), jcfg)
    pt = from_jax_params({"ssm": _numpy_tree(pj)}, device="cpu")["ssm"]
    return (pj, jcfg), (pt, tcfg)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w = _rand(0, 2, 7, 6), _rand(1, 4, 6)
    st = _rand(2, 2, 3, 6) if with_state else None
    yj, sj = jS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    yt, s_t = tS._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                              None if st is None else torch.as_tensor(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=CONV_ATOL)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
    assert s_t.shape == (2, 3, 6)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    """S 37 over chunks of 16: three chunks, the last padded."""
    b, s, h, p, n = 2, 37, 3, 4, 5
    xh, b_, c_ = _rand(3, b, s, h, p), _rand(4, b, s, n), _rand(5, b, s, n)
    dt = np.log1p(np.exp(_rand(6, b, s, h))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    d_skip = _rand(7, h)
    st = 0.1 * _rand(8, b, h, p, n) if with_state else None
    j = [jnp.asarray(a) for a in (xh, dt, a_log, b_, c_, d_skip)]
    t = [torch.as_tensor(a) for a in (xh, dt, a_log, b_, c_, d_skip)]
    yj, sj = jS._ssd_chunked(*j, 16, None if st is None else jnp.asarray(st))
    yt, s_t = tS._ssd_chunked(*t, 16,
                              None if st is None else torch.as_tensor(st))
    assert yt.shape == (b, s, h, p) and s_t.shape == (b, h, p, n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=SSD_ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(sj), rtol=0,
                               atol=SSD_ATOL)


def test_ssd_chunked_is_chunk_invariant():
    """The chunked scan equals the one-chunk scan (the recurrence does not
    depend on the chunk grid)."""
    t = [torch.as_tensor(a) for a in (
        _rand(3, 1, 24, 2, 3),
        np.log1p(np.exp(_rand(6, 1, 24, 2))).astype(np.float32),
        np.log(np.linspace(1.0, 16.0, 2)).astype(np.float32),
        _rand(4, 1, 24, 4), _rand(5, 1, 24, 4), _rand(7, 2))]
    y1, s1 = tS._ssd_chunked(*t, 24)
    y8, s8 = tS._ssd_chunked(*t, 8)
    np.testing.assert_allclose(y8.numpy(), y1.numpy(), rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(s8.numpy(), s1.numpy(), rtol=0, atol=SSD_ATOL)


def test_forward_with_state_and_decode_match_jax():
    """forward (S 40 over smoke chunks of 32) with ``return_state``, then
    two decode steps from that state."""
    (pj, jcfg), (pt, tcfg) = _block()
    x = 0.5 * _rand(9, 2, 40, jcfg.d_model)
    yj, stj = jS.forward(pj, jnp.asarray(x), jcfg, return_state=True)
    with torch.no_grad():
        yt, stt = tS.forward(pt, torch.as_tensor(x), tcfg, return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=SSD_ATOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(stj[k]),
                                   rtol=0, atol=SSD_ATOL)
    for i in range(2):
        xt = 0.5 * _rand(10 + i, 2, 1, jcfg.d_model)
        yj, stj = jS.decode(pj, jnp.asarray(xt), stj, jcfg)
        with torch.no_grad():
            yt, stt = tS.decode(pt, torch.as_tensor(xt), stt, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=SSD_ATOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(stt[k].numpy(), np.asarray(stj[k]),
                                       rtol=0, atol=SSD_ATOL)


def test_decode_continues_forward():
    """forward over S, then decode of token S+1, equals forward over S+1
    at its last position (the port alone)."""
    _, (pt, tcfg) = _block()
    x = torch.as_tensor(0.5 * _rand(11, 2, 9, tcfg.d_model))
    with torch.no_grad():
        full = tS.forward(pt, x, tcfg)
        _, st = tS.forward(pt, x[:, :8], tcfg, return_state=True)
        y, _ = tS.decode(pt, x[:, 8:], st, tcfg)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=0, atol=SSD_ATOL)


def test_init_state_layout():
    _, tcfg = _cfgs()
    st = tS.init_state(tcfg, 3, device="cpu")
    d_in, h, p, n = tS.dims(tcfg)
    assert st["conv"].shape == (3, tcfg.ssm.d_conv - 1, d_in + 2 * n)
    assert st["ssm"].shape == (3, h, p, n)
    assert st["ssm"].dtype == torch.float32


def _tile(cfg):
    st = JLinear.init(jax.random.key(1), D_IN, HID, cfg, bias=False)
    return st, from_jax_params({"t": _numpy_tree(st)}, device="cpu")["t"]


def test_seq_dense_routes_match_jax():
    """Analog and eligible: the temporal route (one read per position);
    a UM config: the single-shot cycle; a digital dict: the plain product.
    Each against JAX's ``_seq_dense`` on the same tile, input and key."""
    from repro_torch.recurrent import temporal as TT
    x = _rand(2, 2, 8, D_IN)
    base = jdev.rpu_nm_bm()
    um = dataclasses.replace(base, update_management=True)
    for cfg, temporal in ((base, True), (um, False)):
        jst, tst = _tile(cfg)
        assert TT.temporal_eligible(tst.meta.cfg) == temporal
        yj = jS._seq_dense(jst, jnp.asarray(x), jax.random.key(3), chunk=4)
        with torch.no_grad():
            yt = tS._seq_dense(tst, torch.as_tensor(x), prng.key(3), 4)
            single = tL.dense_apply(tst, torch.as_tensor(x),
                                    key=prng.key(3))
        assert yt.shape == (2, 8, HID)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=ACT_ATOL)
        # the temporal route keys reads per position, the single-shot
        # cycle one read for all rows: different noise draws
        assert np.array_equal(yt.numpy(), single.numpy()) != temporal
    w = _rand(4, D_IN, HID)
    yj = jS._seq_dense({"w": jnp.asarray(w)}, jnp.asarray(x), None, chunk=4)
    yt = tS._seq_dense({"w": torch.as_tensor(w)}, torch.as_tensor(x), None,
                       4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=CONV_ATOL)
    np.testing.assert_array_equal(yt.numpy(), x @ w)


@pytest.mark.parametrize("s,want", [(40, 20), (37, 1), (32, 32), (8, 8)])
def test_seq_dense_time_chunk(s, want, monkeypatch):
    """The temporal route's time chunk: the largest divisor of S that is
    at most the SSD chunk (32)."""
    from repro_torch.recurrent import temporal as TT
    seen = []
    monkeypatch.setattr(TT, "temporal_dense_apply",
                        lambda p, xs, key, time_chunk: seen.append(
                            time_chunk) or torch.zeros(
                                xs.shape[0], xs.shape[1], HID))
    _, tst = _tile(jdev.rpu_nm_bm())
    tS._seq_dense(tst, torch.zeros(2, s, D_IN), prng.key(3), 32)
    assert seen == [want]


def test_unembed_apply_matches_jax():
    table, x = _rand(12, 11, 6), _rand(13, 2, 3, 6)
    lj = jL.unembed_apply({"table": jnp.asarray(table)}, jnp.asarray(x))
    lt = tL.unembed_apply({"table": torch.as_tensor(table)},
                          torch.as_tensor(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=CONV_ATOL)
