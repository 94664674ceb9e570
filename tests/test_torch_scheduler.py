"""The port's continuous-batching scheduler (``repro_torch.serve.
scheduler``) and ``launch/serve.py --continuous`` on the CPU.

Parity: every request streamed through the slot-rotating scheduler emits
exactly the tokens of a per-request ``engine.greedy_generate`` (the port's
own oracle), across admission and eviction interleavings, for digital
params and for the ``noise_free`` analog policy, on the dense deepseek_7b,
the ssm mamba2_130m and hymba_1_5b with an 8-token ring (prompts shorter
and longer than the window share one slot pool).  The port's scheduler
gives the JAX package's event log and tokens on the same weights and
stream, and the port's ``greedy_generate`` the JAX package's tokens and
caches (``LOGIT_ATOL``).

Properties (a stub engine, no model): random arrival and length streams
never leak or double-assign a slot, never starve a queued request (FIFO
admission), and emit the per-request token chains.
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
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro.serve import scheduler as jsched
from repro_torch.analog.convert import from_jax_params
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE
from repro_torch.serve import scheduler as sched
from repro_torch.utils import prng

from prop_harness import seeded_property
from test_torch_serve import LOGIT_ATOL, _numpy_tree

MAX_SEQ = 16
# hymba_1_5b's smoke config with an 8-token window: a ring of 8 slots
RING = dict(swa_window=8)


def _cfg(arch, spec=None, **over):
    cfg = tregistry.get_config(arch, smoke=True, analog_policy=spec)
    return dataclasses.replace(cfg, param_dtype=torch.float32,
                               act_dtype=torch.float32, **over)


@functools.lru_cache(maxsize=None)
def _setup(arch, spec=None, ring=False):
    cfg = _cfg(arch, spec, **(RING if ring else {}))
    params = tT.init_lm(0, cfg, device="cpu")
    return params, cfg, None if spec is None else prng.key(7)


def _mixed_stream(cfg, n, seed, lengths=(3, 5)):
    """Arrivals and lengths chosen so slots turn over mid-run."""
    rng = np.random.default_rng(seed)
    return [sched.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab,
                            size=int(rng.choice(lengths))).astype(np.int32),
        max_new_tokens=int(rng.integers(1, 5)),
        arrival=int(rng.integers(0, 4)))
        for i in range(n)]


def _oracle_tokens(params, cfg, akey, req, max_seq=MAX_SEQ):
    with torch.no_grad():
        out, _ = tE.greedy_generate(
            params, torch.as_tensor(req.prompt, dtype=torch.int64)[None],
            cfg, n_steps=req.max_new_tokens, max_seq=max_seq, akey=akey)
    return [int(t) for t in out[0]]


def _check_oracle_parity(setup, *, slots=2, n=6, seed=0, eos_id=None,
                         lengths=(3, 5)):
    params, cfg, akey = setup
    reqs = _mixed_stream(cfg, n, seed, lengths)
    s = sched.ContinuousBatchingScheduler(params, cfg, slots=slots,
                                          max_seq=MAX_SEQ, akey=akey,
                                          eos_id=eos_id)
    done = s.run(reqs)
    assert sorted(c.rid for c in done) == sorted(r.rid for r in reqs)
    for comp in done:
        req = next(r for r in reqs if r.rid == comp.rid)
        oracle = _oracle_tokens(params, cfg, akey, req)
        if eos_id is not None and eos_id in oracle:
            oracle = oracle[:oracle.index(eos_id) + 1]
        assert comp.tokens == oracle, (comp.rid, comp.tokens, oracle)
    return s, done


@pytest.mark.parametrize("arch,spec,ring,lengths", [
    ("deepseek_7b", None, False, (3, 5)),
    ("deepseek_7b", "noise_free", False, (3, 5)),
    ("mamba2_130m", None, False, (3, 5)),
    ("hymba_1_5b", None, True, (3, 10)),
    ("hymba_1_5b", "noise_free", True, (3, 10)),
])
def test_scheduler_matches_per_request_oracle(arch, spec, ring, lengths):
    """Token-exact against the per-request loop; hymba's prompts of 3 and
    10 tokens put a padded and a scattered ring in one pool, and decode
    wraps the ring."""
    s, _ = _check_oracle_parity(_setup(arch, spec, ring), seed=0,
                                lengths=lengths)
    pool = s._cache
    assert pool["pos"].dtype == torch.int32
    if arch == "hymba_1_5b":
        assert pool["k"].shape[2] == 8
        assert {"ssm_conv", "ssm_state"} <= set(pool)


def test_scheduler_oracle_parity_across_orderings():
    """Different arrival orders give different admission and eviction
    interleavings; each request still matches its oracle."""
    for seed in (1, 2):
        _check_oracle_parity(_setup("hymba_1_5b", None, True), slots=3,
                             n=8, seed=seed, lengths=(3, 10))


def test_eos_truncates_and_frees_slot():
    params, cfg, akey = _setup("deepseek_7b")
    req = sched.Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                        max_new_tokens=6)
    oracle = _oracle_tokens(params, cfg, akey, req)
    eos = oracle[2]                    # force a mid-stream EOS hit
    s = sched.ContinuousBatchingScheduler(params, cfg, slots=1,
                                          max_seq=MAX_SEQ, eos_id=eos)
    done = s.run([req])
    assert done[0].reason == "eos"
    assert done[0].tokens == oracle[:oracle.index(eos) + 1]
    assert s.n_free == 1


def _jax_params(arch, ring):
    jcfg = dataclasses.replace(
        jregistry.get_config(arch, smoke=True), param_dtype=jnp.float32,
        act_dtype=jnp.float32, remat=False, **(RING if ring else {}))
    pj, _ = jT.init_lm(jax.random.key(0), jcfg)
    return pj, jcfg


def test_scheduler_matches_jax_scheduler():
    """The port's and the JAX package's schedulers on the same weights and
    stream: the same event log and completions."""
    pj, jcfg = _jax_params("hymba_1_5b", True)
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    tcfg = _cfg("hymba_1_5b", **RING)
    reqs = _mixed_stream(tcfg, 6, 0, (3, 10))
    jreqs = [jsched.Request(rid=r.rid, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens,
                            arrival=r.arrival) for r in reqs]
    js = jsched.ContinuousBatchingScheduler(pj, jcfg, slots=2,
                                            max_seq=MAX_SEQ)
    ts = sched.ContinuousBatchingScheduler(pt, tcfg, slots=2,
                                           max_seq=MAX_SEQ)
    jd, td = js.run(jreqs), ts.run(reqs)
    assert [dataclasses.astuple(e) for e in ts.events] == \
        [dataclasses.astuple(e) for e in js.events]
    assert [dataclasses.astuple(c) for c in td] == \
        [dataclasses.astuple(c) for c in jd]


@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_130m",
                                  "hymba_1_5b"])
def test_greedy_generate_matches_jax(arch):
    """The oracle itself: the port's greedy tokens equal JAX's and its
    final cache leaves lie within ``LOGIT_ATOL`` of JAX's."""
    pj, jcfg = _jax_params(arch, arch == "hymba_1_5b")
    pt = from_jax_params(_numpy_tree(pj), device="cpu")
    tcfg = _cfg(arch, **(RING if arch == "hymba_1_5b" else {}))
    toks = np.random.default_rng(3).integers(0, 256, (2, 10))
    oj, cj = jE.greedy_generate(pj, jnp.asarray(toks, jnp.int32), jcfg,
                                n_steps=5, max_seq=MAX_SEQ)
    with torch.no_grad():
        ot, ct = tE.greedy_generate(pt, torch.as_tensor(toks), tcfg,
                                    n_steps=5, max_seq=MAX_SEQ)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert set(ct) == set(cj)
    for k in cj:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   rtol=0, atol=LOGIT_ATOL, err_msg=k)


def test_multi_device_plan_refused():
    params, cfg, _ = _setup("deepseek_7b")
    for plan in (sched.MeshPlan(data=2), sched.MeshPlan(data=4)):
        with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
            sched.ContinuousBatchingScheduler(params, cfg, slots=2,
                                              max_seq=MAX_SEQ, plan=plan)
    sched.ContinuousBatchingScheduler(params, cfg, slots=2,
                                      max_seq=MAX_SEQ, plan=sched.MeshPlan())
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        tserve.serve_continuous("deepseek_7b", slots=2, n_requests=2,
                                prompt_len=4, gen=2, smoke=True,
                                data_mesh=2, device="cpu")


def test_policy_tile_grids():
    from repro_torch.launch import train as ttrain
    cfg = _cfg("deepseek_7b", "*attn*=noise_free:tile_grid=2x2,"
                              "*=noise_free:tile_grid=3x1")
    assert ttrain._policy_tile_grids(cfg) == [(2, 2), (3, 1)]
    assert ttrain._policy_tile_grids(_cfg("deepseek_7b")) == []


def test_scatter_time_matches_jax_past_the_cache():
    """A slot past a linear cache's end writes nothing, as JAX's one-hot
    write does (a free pool row keeps decoding after its request)."""
    from repro.models import attention as jA
    from repro_torch.models import attention as tA
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((4, 6, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 3)).astype(np.float32)
    slot = np.array([0, 5, 6, 9], np.int32)
    want = np.asarray(jA._scatter_time(jnp.asarray(cache), jnp.asarray(new),
                                       jnp.asarray(slot)))
    got = tA._scatter_time(torch.from_numpy(cache), torch.from_numpy(new),
                           torch.from_numpy(slot).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[2:].numpy(), cache[2:])


@pytest.mark.parametrize("arch", [
    "deepseek_7b", "stablelm_3b",
    "hymba_1_5b",                      # window 32 > MAX_SEQ: a linear cache
])
def test_freed_slot_decodes_past_a_full_linear_cache(arch):
    """A request with S + n = max_seq fills its linear cache and frees its
    slot while the other slot decodes four more ticks: the free row's
    ``pos`` runs past the cache, writes nothing, and both requests keep
    their per-request oracle's tokens."""
    params, cfg, akey = _setup(arch)
    assert cfg.swa_window == 0 or cfg.swa_window > MAX_SEQ
    rng = np.random.default_rng(3)
    prompt = lambda n: rng.integers(0, cfg.vocab, size=n).astype(np.int32)
    reqs = [sched.Request(rid=0, prompt=prompt(10), max_new_tokens=6),
            sched.Request(rid=1, prompt=prompt(3), max_new_tokens=6,
                          arrival=3)]
    s = sched.ContinuousBatchingScheduler(params, cfg, slots=2,
                                          max_seq=MAX_SEQ, akey=akey)
    done = {c.rid: c for c in s.run(reqs)}
    assert done[0].finished_step + 2 < done[1].finished_step
    assert int(s._cache["pos"][0]) > MAX_SEQ
    for r in reqs:
        assert done[r.rid].tokens == _oracle_tokens(params, cfg, akey, r)


def test_request_stream_is_jax_stream():
    """``make_requests`` draws the JAX driver's stream for a seed."""
    cfg = _cfg("hymba_1_5b")
    got = tserve.make_requests(cfg, n_requests=9, prompt_len=12, gen=6,
                               slots=3, seed=4)
    rng = np.random.default_rng(4)
    for i, r in enumerate(got):
        n = max(1, int(rng.integers(6, 13)))
        assert r.rid == i
        np.testing.assert_array_equal(r.prompt, rng.integers(
            0, cfg.vocab, size=n).astype(np.int32))
        assert r.max_new_tokens == max(1, int(rng.integers(3, 7)))
        assert r.arrival == int(rng.poisson(1.0) * i // 3)


def test_serve_continuous_on_cpu(capsys):
    done = tserve.serve_continuous(
        "hymba_1_5b", slots=3, n_requests=6, prompt_len=40, gen=6,
        smoke=True, analog_policy="lm_managed", device="cpu")
    assert len(done) == 6
    assert all(1 <= len(c.tokens) <= 6 for c in done)
    out = capsys.readouterr().out
    assert "continuous: 6/6 requests" in out


@pytest.mark.parametrize("arch,flags", [
    ("mamba2_130m", ["--prompt-len", "8", "--gen", "4", "--requests", "4"]),
    # seed 0's stream ends with a slot free for two ticks after a request
    # filled its linear cache of P + G
    ("stablelm_3b", ["--prompt-len", "4", "--gen", "8", "--requests", "4"]),
])
def test_cli_continuous_on_cpu(capsys, monkeypatch, arch, flags):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--continuous", "--slots", "2", *flags])
    tserve.main()
    assert "continuous: 4/4 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Properties: slot lifecycle over a stub engine (no model in the loop)
# ---------------------------------------------------------------------------

class StubScheduler(sched.ContinuousBatchingScheduler):
    """The two model-touching methods replaced by a deterministic token
    chain: any failure is a scheduler bug."""

    def __init__(self, *, slots, eos_id=None):
        self._init_bookkeeping(slots, eos_id)

    def _admit_slot(self, req, slot):
        return int(req.prompt[-1]) * 7 % 97

    def _decode_tokens(self, last_tokens):
        return (last_tokens * 31 + 7) % 97


def _stub_oracle(req, eos_id):
    tok = int(req.prompt[-1]) * 7 % 97
    toks = [tok]
    while not (eos_id is not None and tok == eos_id) \
            and len(toks) < max(1, req.max_new_tokens):
        tok = (tok * 31 + 7) % 97
        toks.append(tok)
    return toks


def _run_stub(seed):
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(1, 5))
    eos_id = 7 if rng.integers(2) else None
    reqs = [sched.Request(
        rid=i, prompt=rng.integers(0, 97, size=int(rng.integers(1, 9))
                                   ).astype(np.int32),
        max_new_tokens=int(rng.integers(1, 9)),
        arrival=int(rng.integers(0, 10)))
        for i in range(int(rng.integers(1, 25)))]
    s = StubScheduler(slots=slots, eos_id=eos_id)
    return s, reqs, s.run(reqs), eos_id


@seeded_property()
def test_prop_slots_never_leak_or_double_assign(seed):
    s, _, _, _ = _run_stub(seed)
    held = {}
    for ev in s.events:
        if ev.kind == "admit":
            assert ev.slot not in held, f"double-assign slot {ev.slot}"
            assert 0 <= ev.slot < s.slots
            held[ev.slot] = ev.rid
        else:
            assert held.get(ev.slot) == ev.rid, f"freeing foreign slot {ev}"
            del held[ev.slot]
    assert not held, f"leaked slots {held}"
    assert s.n_free == s.slots


@seeded_property()
def test_prop_no_starvation_fifo_admission(seed):
    s, reqs, done, _ = _run_stub(seed)
    assert sorted(c.rid for c in done) == sorted(r.rid for r in reqs)
    admitted = [ev.rid for ev in s.events if ev.kind == "admit"]
    assert admitted == [r.rid for r in sorted(reqs, key=lambda r: r.arrival)]


@seeded_property()
def test_prop_token_conservation(seed):
    _, reqs, done, eos_id = _run_stub(seed)
    by_rid = {c.rid: c for c in done}
    total = 0
    for r in reqs:
        oracle = _stub_oracle(r, eos_id)
        assert by_rid[r.rid].tokens == oracle, r.rid
        total += len(oracle)
    assert sum(len(c.tokens) for c in done) == total
