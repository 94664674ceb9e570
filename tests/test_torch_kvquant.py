"""The int8 KV cache (``kv_cache_quant``): the port against the JAX package
on the CPU, float32.

* ``quantize_kv`` (``round(16 x)`` clipped to +-127, int8; both packages
  round half to even) and ``dequantize_kv`` bitwise JAX's, on float32 and
  bfloat16 inputs that hold every exact half step from -130/16 to 130/16,
  values past +-127/16 and seeded normals;
* ``_scatter_time`` into an int8 cache bitwise JAX's, a slot past the
  cache writing nothing;
* the port's counterpart of ``tests/test_serve_features.py``'s int8 cache
  tests, on qwen3_14b's smoke config (a linear cache) and hymba_1_5b's (a
  ring of its 32-slot window, the 40-token prompt past it), digital and
  under the noisy ``lm_managed``, from the JAX package's weights: a
  prefill and N_STEPS greedy decode steps in both packages; logits within
  ``LOGIT_ATOL`` (1e-4) and greedy tokens equal; the cache leaves int8,
  each of the port's codes exactly ``quantize_kv`` of the float the port
  quantized, and equal to JAX's code except at most MAX_FLIPS codes per
  run, each one apart and each where that float lies within HALF_ATOL
  (1e-5) of a half step ``(n + 1/2) / 16`` (float32 reassociation may
  round such a float the other way); the int8 decode's next-token
  distribution within 0.05 of the float cache's, as JAX's test holds it;
* the encoder-decoder keeps its cross K/V in float32 beside an int8 self
  cache, and ``init_cache`` lays out the prefill's dtypes;
* the continuous-batching scheduler on an int8 pool (qwen3_14b's linear
  cache and hymba_1_5b's ring of 8), the port's and the JAX package's on
  the same weights and stream: the same event log and completions, every
  request's tokens those of a per-request ``greedy_generate``, the final
  pool's ``k`` and ``v`` int8, each code ``quantize_kv`` of the float the
  port quantized into that place, and equal to JAX's but for the
  MAX_FLIPS half-step flips above.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro.serve import scheduler as jsched
from repro_torch.analog.convert import from_jax_params
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.serve import scheduler as tsched
from repro_torch.utils import prng

from test_torch_serve import LOGIT_ATOL, _numpy_tree

NOISY = "lm_managed"
AKEY, B, PROMPT, N_STEPS, MAX_SEQ = 7, 2, 40, 6, 48
MAX_FLIPS = 4
HALF_ATOL = 1e-5
QUANTIZE = tattn.quantize_kv          # before a test records its calls


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values():
    half = (np.arange(-130, 130) + 0.5) / 16.0
    past = np.array([127.5, 128.0, 200.0, 1e4]) / 16.0
    rng = np.random.default_rng(0)
    return np.concatenate([half, past, -past, [0.0, -0.0, 127 / 16.0],
                           rng.normal(0, 3.0, 4000)]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_are_jax_bitwise(dtype):
    xj = jnp.asarray(_values()).astype(dtype)
    xt = torch.from_numpy(_values()).to(getattr(torch, dtype))
    qj, qt = jattn.quantize_kv(xj), tattn.quantize_kv(xt)
    assert qt.dtype == torch.int8 and qj.dtype == jnp.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    # half to even: 0.5/16 -> 0, 1.5/16 -> 2, -2.5/16 -> -2
    probe = torch.tensor([0.5, 1.5, -2.5, 2.5]) / 16
    assert tattn.quantize_kv(probe).tolist() == [0, 2, -2, 2]
    assert tattn.quantize_kv(torch.tensor([9.0, -9.0])).tolist() == [127,
                                                                     -127]
    for out in ("float32", "bfloat16"):
        dj = jattn.dequantize_kv(qj, getattr(jnp, out))
        dt = tattn.dequantize_kv(qt, getattr(torch, out))
        assert dt.dtype == getattr(torch, out)
        np.testing.assert_array_equal(dt.float().numpy(),
                                      np.asarray(dj.astype(jnp.float32)))
    # a float cache passes through
    assert tattn.dequantize_kv(xt, torch.float32) is xt


def test_scatter_time_into_an_int8_cache_is_jax_bitwise():
    rng = np.random.default_rng(2)
    cache = rng.integers(-127, 128, (3, 6, 2, 4)).astype(np.int8)
    new = rng.normal(0, 3.0, (3, 1, 2, 4)).astype(np.float32)
    slot = np.array([0, 5, 9], np.int32)          # row 2: past the cache
    got = tattn._scatter_time(torch.from_numpy(cache), torch.from_numpy(new),
                              torch.from_numpy(slot))
    want = jattn._scatter_time(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(slot))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), cache[2])


@functools.lru_cache(maxsize=None)
def _pair(arch, spec, quant=True, window=0):
    over = dict(kv_cache_quant=quant, remat=False)
    if window:
        over["swa_window"] = window
    jcfg = dataclasses.replace(
        jregistry.get_config(arch, smoke=True), param_dtype=jnp.float32,
        act_dtype=jnp.float32,
        analog_policy=None if spec is None else jpresets.parse_policy(spec),
        **over)
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    tcfg = dataclasses.replace(
        tregistry.get_config(arch, smoke=True, analog_policy=spec),
        param_dtype=torch.float32, act_dtype=torch.float32, **over)
    return (pj, jcfg), (from_jax_params(_numpy_tree(pj), device="cpu"), tcfg)


def _toks():
    return np.random.default_rng(1).integers(0, 256, (B, PROMPT))


def _keys(spec, i=None):
    if spec is None:
        return None, None
    jk, tk = jax.random.key(AKEY), prng.key(AKEY)
    if i is None:
        return jk, tk
    return jE.decode_step_key(jk, i), tE.decode_step_key(tk, i)


def _jax_run(arch, spec):
    (pj, jcfg), _ = _pair(arch, spec)
    lg, cache = jE.prefill(pj, jnp.asarray(_toks(), jnp.int32), jcfg,
                           max_seq=MAX_SEQ, akey=_keys(spec)[0])
    logits, caches = [np.asarray(lg)], [cache]
    for i in range(N_STEPS):
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
        lg, cache = jE.serve_step(pj, tok, cache, jcfg,
                                  akey=_keys(spec, i)[0])
        logits.append(np.asarray(lg))
        caches.append(cache)
    return logits, caches


def _port_run(arch, spec, monkeypatch, quant=True):
    """Prefill and N_STEPS decode steps; with ``quant`` also the floats
    that ``quantize_kv`` took, placed where their codes went: a float
    cache beside each int8 one."""
    _, (pt, tcfg) = _pair(arch, spec, quant)
    seen = []
    real = tattn.quantize_kv

    def recorded(x):
        seen.append(x.detach().float().clone())
        return real(x)

    monkeypatch.setattr(tattn, "quantize_kv", recorded)
    n = tcfg.n_layers
    with torch.no_grad():
        lg, cache = tE.prefill(pt, torch.as_tensor(_toks()), tcfg,
                               max_seq=MAX_SEQ, akey=_keys(spec)[1])
        cl = cache["k"].shape[2]
        ring = tattn._ring(tcfg, cache["k"][0])
        place = (lambda t: tT._ring_cache_from_full(t, cl)) if ring else (
            lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, cl - t.shape[1])))
        fl = {kv: torch.stack([place(seen[2 * li + j]) for li in range(n)])
              for j, kv in enumerate("kv")} if quant else None
        logits, caches, floats = [lg], [cache], [fl]
        for i in range(N_STEPS):
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            mark = len(seen)
            lg, cache = tE.serve_step(pt, tok, cache, tcfg,
                                      akey=_keys(spec, i)[1])
            logits.append(lg)
            caches.append(cache)
            if quant:
                pos = PROMPT + i
                slot = pos % cl if ring else pos
                fl = {kv: t.clone() for kv, t in fl.items()}
                for li in range(n):
                    for j, kv in enumerate("kv"):
                        fl[kv][li][:, slot] = seen[mark + 2 * li + j][:, 0]
                floats.append(fl)
    return logits, caches, floats


def _check_codes(tcache, jcache, floats):
    """Returns the number of codes that differ from JAX's."""
    flips = 0
    for kv in ("k", "v"):
        got, want = tcache[kv], np.asarray(jcache[kv])
        assert got.dtype == torch.int8 and want.dtype == np.int8
        f = floats[kv]
        assert torch.equal(got, QUANTIZE(f)), kv
        diff = got.numpy().astype(np.int16) - want.astype(np.int16)
        where = np.nonzero(diff)
        assert np.abs(diff).max(initial=0) <= 1, kv
        x = f.numpy()[where] * 16.0
        assert np.all(np.abs(x - (np.floor(x) + 0.5))
                      <= 16.0 * HALF_ATOL), kv
        flips += len(where[0])
    return flips


ARCHS = ["qwen3_14b", "hymba_1_5b"]


@pytest.mark.parametrize("spec", [None, NOISY], ids=["digital", "noisy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_matches_jax(arch, spec, monkeypatch):
    jl, jc = _jax_run(arch, spec)
    tl, tc, tf = _port_run(arch, spec, monkeypatch)
    flips = 0
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=LOGIT_ATOL)
        assert np.array_equal(a[:, -1].argmax(-1).numpy(),
                              b[:, -1].argmax(-1))
    for tcache, jcache, fl in zip(tc, jc, tf):
        assert set(tcache) == set(jcache)
        flips += _check_codes(tcache, jcache, fl)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert flips <= MAX_FLIPS
    if arch == "hymba_1_5b":
        assert tc[0]["k"].shape[2] == 32 < PROMPT        # a ring
        np.testing.assert_allclose(tc[-1]["ssm_state"].numpy(),
                                   np.asarray(jc[-1]["ssm_state"]), rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_tracks_the_float_cache(arch, monkeypatch):
    """JAX's ``test_kv_quant_decode_close_to_fp``, on the port: the
    first decode step's next-token distribution within 0.05 of the float
    cache's, the prefill's codes ``quantize_kv`` of the float cache."""
    ql, qc, _ = _port_run(arch, None, monkeypatch)
    fl, fc, _ = _port_run(arch, None, monkeypatch, quant=False)
    assert fc[0]["k"].dtype == torch.float32
    assert torch.equal(qc[0]["k"], tattn.quantize_kv(fc[0]["k"]))
    assert torch.equal(qc[0]["v"], tattn.quantize_kv(fc[0]["v"]))
    pq = torch.softmax(ql[1][:, 0], -1)
    pf = torch.softmax(fl[1][:, 0], -1)
    assert float((pq - pf).abs().max()) < 0.05


def test_encoder_decoder_cross_cache_stays_float():
    arch = "seamless_m4t_medium"
    (pj, jcfg), (pt, tcfg) = _pair(arch, None)
    frames = np.random.default_rng(3).normal(0, 0.5, (B, 10, 64)).astype(
        np.float32)
    _, cj = jE.prefill(pj, jnp.asarray(_toks()[:, :12], jnp.int32), jcfg,
                       max_seq=20, enc_embeds=jnp.asarray(frames))
    with torch.no_grad():
        _, ct = tE.prefill(pt, torch.as_tensor(_toks()[:, :12]), tcfg,
                           max_seq=20, enc_embeds=torch.from_numpy(frames))
    init = tE.init_cache(tcfg, B, 20, src_len=10, device="cpu")
    assert set(init) == set(ct)
    for k in ct:
        assert ct[k].dtype == init[k].dtype, k
        assert tuple(ct[k].shape) == tuple(init[k].shape), k
    assert ct["k"].dtype == torch.int8 and ct["cross_k"].dtype == (
        torch.float32)
    for k in ("k", "v"):
        diff = ct[k].numpy().astype(np.int16) - np.asarray(cj[k]).astype(
            np.int16)
        assert np.count_nonzero(diff) <= MAX_FLIPS
        assert np.abs(diff).max() <= 1
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=0,
                                   atol=LOGIT_ATOL)


class _Recorded(tsched.ContinuousBatchingScheduler):
    """The port's scheduler that keeps, beside its int8 pool, the floats
    its codes were made from, in the same places: ``seen`` is the list
    that the recording ``quantize_kv`` appends to."""

    def __init__(self, *a, seen, **kw):
        super().__init__(*a, **kw)
        self.seen, self.floats = seen, None

    def _admit_slot(self, req, slot):
        mark = len(self.seen)
        tok = super()._admit_slot(req, slot)
        cl, w = self._cache["k"].shape[2], self.cfg.swa_window
        place = (lambda t: tT._ring_cache_from_full(t, min(w, cl))) if w \
            else (lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, cl - t.shape[1])))
        if self.floats is None:
            self.floats = {kv: torch.zeros(self._cache[kv].shape)
                           for kv in "kv"}
        for li in range(self.cfg.n_layers):
            for j, kv in enumerate("kv"):
                self.floats[kv][li, slot] = place(
                    self.seen[mark + 2 * li + j])[0]
        return tok

    def _decode_tokens(self, last_tokens):
        mark, pos = len(self.seen), self._cache["pos"].clone()
        nxt = super()._decode_tokens(last_tokens)
        ring = tattn._ring(self.cfg, self._cache["k"][0])
        slot = pos % self.cfg.swa_window if ring else pos
        for li in range(self.cfg.n_layers):
            for j, kv in enumerate("kv"):
                # a float cache: written as it is, not quantized
                self.floats[kv][li] = tattn._scatter_time(
                    self.floats[kv][li], self.seen[mark + 2 * li + j], slot)
        return nxt


@pytest.mark.parametrize("arch,window", [("qwen3_14b", 0),
                                         ("hymba_1_5b", 8)])
def test_scheduler_serves_an_int8_pool(arch, window, monkeypatch):
    """The port's and the JAX package's schedulers on an int8 pool, from
    the same weights and stream (``test_torch_scheduler.py``'s
    ``test_scheduler_matches_jax_scheduler``): events, completions, pool
    positions equal; pool codes as ``_check_codes`` holds them; tokens
    those of the port's per-request ``greedy_generate``."""
    (pj, jcfg), (pt, tcfg) = _pair(arch, None, window=window)
    rng = np.random.default_rng(5)
    reqs = [tsched.Request(rid=i, prompt=rng.integers(
        0, tcfg.vocab, size=int(rng.choice((3, 10)))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 5)), arrival=int(i // 2))
        for i in range(6)]
    jreqs = [jsched.Request(rid=r.rid, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens,
                            arrival=r.arrival) for r in reqs]
    js = jsched.ContinuousBatchingScheduler(pj, jcfg, slots=2, max_seq=16)
    jd = js.run(jreqs)
    seen = []
    real = tattn.quantize_kv

    def recorded(x):
        seen.append(x.detach().float().clone())
        return real(x)

    monkeypatch.setattr(tattn, "quantize_kv", recorded)
    ts = _Recorded(pt, tcfg, slots=2, max_seq=16, seen=seen)
    td = ts.run(reqs)
    monkeypatch.undo()
    assert [dataclasses.astuple(e) for e in ts.events] == \
        [dataclasses.astuple(e) for e in js.events]
    assert [dataclasses.astuple(c) for c in td] == \
        [dataclasses.astuple(c) for c in jd]
    pool = ts._cache
    assert pool["k"].dtype == pool["v"].dtype == torch.int8
    assert pool["k"].shape[2] == (window or 16)
    assert _check_codes(pool, js._cache, ts.floats) <= MAX_FLIPS
    np.testing.assert_array_equal(pool["pos"].numpy(),
                                  np.asarray(js._cache["pos"]))
    done = {c.rid: c.tokens for c in td}
    for r in reqs:
        with torch.no_grad():
            out, _ = tE.greedy_generate(
                pt, torch.as_tensor(r.prompt, dtype=torch.int64)[None],
                tcfg, n_steps=r.max_new_tokens, max_seq=16)
        assert done[r.rid] == [int(t) for t in out[0]], r.rid
