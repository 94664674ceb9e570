"""The sequence engines of ``repro_torch.train.engine`` and the recurrent
trainer ``repro_torch.launch.train`` on the CPU (the engine runs
uncaptured there, through the plain versions of the kernels and of the key
schedule).

* ``engine="scan"`` is bitwise ``engine="python"``: tiles, digital leaves
  and per-epoch accuracies, under digital training, the paper's iterative
  BM (at ``out_bound=1``, where reads retry: as many retries counted in
  both engines), two-phase BM with the fused update, and GRU on the
  separate route;
* ``make_seq_eval_fn`` gives the JAX package's accuracy (within one
  answer in 1e6) with every site digital, on the same parameters;
* the full-width T = 34 step under iterative BM fits the key tape;
* the trainer's defaults and key layout are the JAX package's, and archs
  of the families the port lacks are refused.

The CUDA case (marked ``cuda``) needs the card and skips here;
``chip_smoke.py`` phase l holds the captured graph against the loop there.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.launch import train as jtrain
from repro.recurrent import model as JM
from repro.train import engine as jengine
from repro_torch.analog.convert import from_jax_params
from repro_torch.core import management
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.recurrent import model as M
from repro_torch.train import engine as tengine
from repro_torch.utils import prng

# at the figure's alpha 2 no read of the first epochs saturates; at 1 they
# retry
IT_A1 = "nm_bm:use_pallas=true:out_bound=1"
FUSED = "nm_bm:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
SEPARATE = "nm_bm:use_pallas=true:bm_mode=two_phase"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(params):
    return [t.detach() for t, _ in topt.leaves(params)]


@pytest.mark.parametrize("kind,policy", [
    ("lstm", None), ("lstm", IT_A1), ("lstm", FUSED), ("gru", SEPARATE)],
    ids=["digital", "iterative", "fused", "gru_separate"])
def test_scan_engine_bitwise_python(kind, policy):
    runs = {}
    for engine in ("scan", "python"):
        with management.count_retries("cpu") as n:
            r = ttrain.train_sequence(
                kind, steps=2, batch=4, seq=4, smoke=True,
                analog_policy=policy, lr=0.05, device="cpu", engine=engine,
                return_params=True, verbose=False, seed=1)
        runs[engine] = r, int(n)
    (scan, n_scan), (loop, n_loop) = runs["scan"], runs["python"]
    assert scan["accuracies"] == loop["accuracies"]
    a, b = _leaves(scan["params"]), _leaves(loop["params"])
    assert len(a) == (5 if policy is None else 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the scan engine's warm-up step retries too, on copies of the tiles
    assert (n_scan > n_loop > 0) if policy == IT_A1 else n_scan == n_loop \
        == 0
    init = ttrain.build(kind, batch=4, seq=4, smoke=True, analog=False,
                        analog_policy=policy, lr=0.05, bm_mode="iterative",
                        use_pallas=False, fuse_bwd_update=False,
                        time_chunk=1, seed=1, device="cpu")[1]
    assert not all(torch.equal(x, y) for x, y in zip(a, _leaves(init)))


def test_retries_equal_in_both_engines():
    """Iterative BM at ``out_bound=1``: from the same tiles, the second
    epoch's retries (no warm-up step in it) are as many in the scan engine
    as in the loop, and not zero."""
    counts = {}
    for engine in ("scan", "python"):
        scfg, params, opt, (tok, tgt), _ = ttrain.build(
            "lstm", batch=4, seq=4, smoke=True, analog=False,
            analog_policy=IT_A1, lr=0.05, bm_mode="iterative",
            use_pallas=False, fuse_bwd_update=False, time_chunk=1, seed=1,
            device="cpu")
        if engine == "scan":
            run = tengine.make_seq_epoch_fn(scfg, opt, batch=4)
        else:
            from repro_torch.train import cnn
            step = tengine.make_seq_step_fn(scfg, opt)
            run = lambda p, *a: cnn.python_epoch(step, p, *a,  # noqa: E731
                                                 batch=4)
        with management.count_retries("cpu") as n:
            for epoch in (0, 1):
                n.zero_()
                run(params, tok, tgt, prng.key(3), prng.key(4), epoch)
        counts[engine] = int(n), _leaves(params)
    assert counts["scan"][0] == counts["python"][0] > 0
    assert all(torch.equal(x, y) for x, y in zip(counts["scan"][1],
                                                  counts["python"][1]))


def test_seq_eval_matches_jax_digital():
    jcfg = JM.SeqConfig(hidden=16, seq_len=4)
    tcfg = M.SeqConfig(hidden=16, seq_len=4)
    jp, _ = JM.init(jax.random.key(0), jcfg)
    from repro.data import sequences as jseq
    tok, tgt = jseq.copy_task(70, seq_len=4, seed=5)
    key = jax.random.key(6)
    want = float(jengine.make_seq_eval_fn(jcfg, batch=32)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), key))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    k = prng.from_key_data(jax.random.key_data(key))
    got = tengine.make_seq_eval_fn(tcfg, batch=32)(
        tp, torch.from_numpy(tok), torch.from_numpy(tgt), k)
    loop = ttrain.python_eval(tcfg, tp, torch.from_numpy(tok),
                              torch.from_numpy(tgt), k, 32)
    assert got == loop
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.0 < got < 1.0


def test_full_width_iterative_step_fits_the_tape():
    """One full-width LSTM step (hidden 32, T = 34, batch 8) under the
    trainer's default iterative BM, recorded on a key tape: 138 managed
    reads (34 x 2 forward, 34 x 2 transpose, the readout both ways), each
    a first read and 10 predicated retries."""
    scfg, params, opt, (tok, tgt), _ = ttrain.build(
        "lstm", batch=8, seq=16, smoke=False, analog=True,
        analog_policy=None, lr=0.01, bm_mode="iterative", use_pallas=True,
        fuse_bwd_update=False, time_chunk=1, seed=0, device="cpu")
    assert scfg.t_total == 34
    assert tuple(params["cell"]["wx"].w.shape) == (128, 9)
    assert tuple(params["cell"]["wh"].w.shape) == (128, 32)
    assert tuple(params["readout"].w.shape) == (8, 33)
    tape = prng.KeyTape("cpu")
    tengine.make_seq_step_fn(scfg, opt)(params, tok[:8], tgt[:8],
                                        tape.begin())
    tape.end()
    parent, _, seeds = tape.recorded
    assert len(seeds) == 138 * 11 + 9        # + the update streams and ctoc
    assert len(parent) + 1 < prng.TAPE_SLOTS


def test_trainer_defaults_and_keys_match_jax():
    port = inspect.signature(ttrain.train_sequence).parameters
    for name, p in inspect.signature(jtrain.train_sequence).parameters.items():
        assert port[name].default == p.default, name
    # params from key(seed), converted under key(seed): JAX's tiles
    scfg, params, *_ = ttrain.build(
        "gru", batch=4, seq=4, smoke=True, analog=True, analog_policy=None,
        lr=0.01, bm_mode="two_phase", use_pallas=False,
        fuse_bwd_update=False, time_chunk=1, seed=3, device="cpu")
    from repro.analog.convert import convert_to_analog as jconvert
    from repro.analog.policy import AnalogPolicy, AnalogRule
    from repro.core.device import rpu_nm_bm
    import dataclasses
    jcfg = JM.SeqConfig(kind="gru", hidden=16, seq_len=4)
    jp, ja = JM.init(jax.random.key(3), jcfg)
    rule = AnalogRule("*", dataclasses.replace(rpu_nm_bm(),
                                               bm_mode="two_phase"), "nm_bm")
    jp, _ = jconvert(jp, ja, AnalogPolicy(rules=(rule,)),
                     key=jax.random.key(3))
    for got, want in ((params["cell"]["wx"], jp["cell"]["wx"]),
                      (params["cell"]["wh"], jp["cell"]["wh"]),
                      (params["readout"], jp["readout"])):
        assert got.seed == prng.from_key_data(jax.random.key_data(want.seed))
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=5e-7, atol=0)


def test_other_archs_are_refused():
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        ttrain.train("mixtral_8x7b", steps=1, batch=2, seq=8, smoke=True)
    with pytest.raises(ValueError, match="unknown engine"):
        ttrain.train_sequence("lstm", steps=1, batch=2, seq=4, smoke=True,
                              device="cpu", engine="jit")


def test_cli_trains_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "gru", "--smoke", "--steps", "1", "--batch",
        "2", "--analog", "--bm-mode", "two_phase", "--device", "cpu"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "[train gru] epoch 0 copy-task accuracy" in out
    assert "on cpu, engine scan" in out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [FUSED, IT_A1], ids=["fused", "it"])
def test_cuda_graphed_seq_epoch_matches_loop(policy, cuda):
    runs = [ttrain.train_sequence(
        "lstm", steps=1, batch=8, seq=16, smoke=False, analog_policy=policy,
        device=cuda, engine=engine, return_params=True, verbose=False)
        for engine in ("scan", "python")]
    torch.cuda.synchronize()
    a, b = (_leaves(r["params"]) for r in runs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
