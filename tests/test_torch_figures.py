"""The paper's figure runs on the port against the JAX package: the run
table, the trainer's JSON history, the LeNet pieces the runs need
(``replace_layer``, ``conv_padding``, ``accuracy``), the committed seed
bands (``repro_torch/benchmarks/jax_bands.json``) and their rule.

Nothing here trains more than a step: the seed sweeps run on the card
(``python -m repro_torch.benchmarks.cnn_suite``), and the JAX bands are
made once, outside pytest, by this file's own entry point::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_figures.py \\
        --write-bands [--jobs 4]

which trains every run of ``cnn_suite.PAIRS`` in the JAX package at
``cnn_suite.BAND_PROTOCOL`` over ``cnn_suite.BAND_SEEDS`` (one process per
run and seed) and writes the JSON.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch.benchmarks import bands as tbands
from repro_torch.benchmarks import cnn_suite as tsuite
from repro_torch.utils import prng

# the JAX package's benchmarks/ (the run table, the paper's numbers, Table
# 2) is a directory of the repository root, not of src/
ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """With several pytest-xdist workers at once, torch's thread pool in
    each oversubscribes the cores (the iterative-BM engine tests took 162 s
    instead of 10 beside five busy workers), so this module's plain-version
    kernels run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The run table, the policy and the trainer's JSON history
# ---------------------------------------------------------------------------

def _same_cfg(t, j):
    """Every field of the two packages' RPUConfigs equal (dtype by name:
    a torch dtype in the port, a numpy-like one in JAX)."""
    if t is None or j is None:
        return t is None and j is None
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            if str(a).split(".")[-1] != np.dtype(b).name:
                return False
        elif a != b:
            return False
    return True


def test_run_tables_name_the_same_runs():
    from benchmarks import cnn_suite as jsuite
    assert list(tsuite.RUNS) == list(jsuite.RUNS)
    assert len(tsuite.RUNS) == 26
    assert tsuite.FIGURES == jsuite.FIGURES
    assert tsuite.PROTOCOL == jsuite.PROTOCOL
    assert tsuite.PAPER_PROTOCOL == jsuite.PAPER_PROTOCOL
    from benchmarks import figures as jfigures
    assert tsuite.PAPER == jfigures.PAPER


@pytest.mark.parametrize("name", list(tsuite.RUNS))
def test_run_resolves_like_jax(name):
    """Each run, layer by layer and field by field, resolves to the JAX
    package's device config, mode and rule label."""
    from benchmarks import cnn_suite as jsuite
    t, j = tsuite.RUNS[name](), jsuite.RUNS[name]()
    assert (t.mode, t.lr, t.conv_padding) == (j.mode, j.lr, j.conv_padding)
    for layer in ("K1", "K2", "W3", "W4"):
        assert _same_cfg(t.resolved(layer), j.resolved(layer)), layer
        assert t.layer_mode(layer) == j.layer_mode(layer)
        assert t.label(layer) == j.label(layer)


def test_policy_constructors_match_jax():
    from repro.analog.policy import AnalogPolicy as JPolicy
    from repro.core import device as jdev
    from repro_torch.analog.policy import AnalogPolicy as TPolicy
    from repro_torch.core import device as tdev
    paths = ["K1", "K2", "W3", "W4", "layers/attn/q", "a*b", "unembed"]
    cases = [
        (TPolicy.uniform(tdev.rpu_nm_bm()), JPolicy.uniform(jdev.rpu_nm_bm())),
        (TPolicy.exact({"K2": tdev.rpu_full(13), "a*b": None},
                       default=tdev.rpu_baseline()),
         JPolicy.exact({"K2": jdev.rpu_full(13), "a*b": None},
                       default=jdev.rpu_baseline())),
        (TPolicy.of(("re:^W", tdev.rpu_nm_bm(), "dense"), ("K*", None))
         .prepend("W4", tdev.rpu_baseline(), "W4"),
         JPolicy.of(("re:^W", jdev.rpu_nm_bm(), "dense"), ("K*", None))
         .prepend("W4", jdev.rpu_baseline(), "W4")),
    ]
    for t, j in cases:
        t2 = t.map_configs(lambda c: dataclasses.replace(c, bl=3))
        j2 = j.map_configs(lambda c: dataclasses.replace(c, bl=3))
        for tp, jp in ((t, j), (t2, j2)):
            assert tp.describe(paths) == jp.describe(paths)
            assert bool(tp) == bool(jp)
            for path in paths:
                assert _same_cfg(tp.resolve(path), jp.resolve(path)), path
    assert not TPolicy() and not JPolicy()


def test_log_path_matches_jax(tmp_path):
    """The trainer's JSON history has the JAX package's keys, and its
    ``config`` is the JAX ``_describe`` of the same run, for three runs of
    the table (one training step each; runs without iterative BM, whose
    padded evaluation batch is slow on the CPU)."""
    from benchmarks import cnn_suite as jsuite
    from repro.train import cnn as jcnn
    from repro_torch.train import cnn as tcnn
    proto = dict(epochs=1, batch=8, n_train=8, n_test=8, seed=0)
    jpath = tmp_path / "jax.json"
    jcnn.train(jsuite.RUNS["fp_baseline"](), log_path=str(jpath),
               verbose=False, engine="python", **proto)
    want = json.loads(jpath.read_text())
    for name in ("fp_baseline", "fig3a_no_noise_no_bound", "fig3b_nm_only"):
        path = tmp_path / f"{name}.json"
        r = tcnn.train(tsuite.RUNS[name](), log_path=str(path),
                       verbose=False, device="cpu", **proto)
        got = json.loads(path.read_text())
        assert set(got) == set(want), name
        assert got["protocol"] == want["protocol"]
        assert got["test_error"] == r["test_error"]
        assert got["config"] == jcnn._describe(jsuite.RUNS[name]()), name


def test_eval_every_epoch_off_evaluates_once():
    from repro_torch.train import cnn as tcnn
    r = tcnn.train(tsuite.RUNS["fp_baseline"](), epochs=2, batch=8,
                   n_train=8, n_test=8, device="cpu", verbose=False,
                   eval_every_epoch=False)
    assert len(r["test_error"]) == 1


def test_on_kernels_sets_the_flags():
    cfg = tsuite.on_kernels(tsuite.RUNS["fig4_dpw13_K2"]())
    flags = tsuite.kernel_flags(cfg)
    assert all(f["use_pallas"] and f["iterative_bm"]
               and not f["fuse_bwd_update"] for f in flags.values())
    cfg = tsuite.on_kernels(tsuite.config("nm_bm_two_phase"))
    assert all(f["fuse_bwd_update"]
               for f in tsuite.kernel_flags(cfg).values())
    assert tsuite.kernel_flags(
        tsuite.on_kernels(tsuite.RUNS["fp_baseline"]())) == {}


# ---------------------------------------------------------------------------
# LeNet pieces: conv_padding and accuracy against JAX
# ---------------------------------------------------------------------------

LOGIT_ATOL = 1e-6     # f32 reassociation through four layers (as the
                      # one-step test of test_torch_lenet.py)
REF = "managed:bm_mode=two_phase"


def _numpy_tree(params):
    out = {}
    for name, s in params.items():
        node = {"w": np.asarray(s.w),
                "seed": np.asarray(jax.random.key_data(s.seed)),
                "meta": s.meta}
        if s.maps is not None:
            node["maps"] = {f: np.asarray(getattr(s.maps, f))
                            for f in ("dw_up", "dw_dn", "bound")}
        out[name] = node
    return out


def _both(padding):
    from repro.analog import presets as jpresets
    from repro.models import lenet as jlenet
    from repro_torch.analog import presets as tpresets
    from repro_torch.analog.convert import from_jax_params
    from repro_torch.models import lenet as tlenet
    jcfg = jlenet.LeNetConfig.from_policy(jpresets.parse_policy(REF),
                                          conv_padding=padding)
    tcfg = tlenet.LeNetConfig.from_policy(tpresets.parse_policy(REF),
                                          conv_padding=padding)
    pj = jlenet.init(jax.random.key(3), jcfg)
    return jlenet, tlenet, jcfg, tcfg, pj, from_jax_params(
        _numpy_tree(pj), device="cpu")


@pytest.mark.parametrize("padding", ["SAME", ((2, 2), (2, 2)),
                                     ((1, 3), (0, 4))],
                         ids=["same", "pad2", "asymmetric"])
def test_conv_padding_forward_matches_jax(padding):
    jlenet, tlenet, jcfg, tcfg, pj, pt = _both(padding)
    assert tlenet.feature_sizes(tcfg) == jlenet.feature_sizes(jcfg)
    assert tuple(pt["W3"].w.shape) == tuple(pj["W3"].w.shape)
    x = np.random.default_rng(0).uniform(0, 1, (2, 28, 28, 1)).astype(
        np.float32)
    lj = jlenet.apply(pj, x, jax.random.key(5), jcfg)
    with torch.no_grad():
        lt = tlenet.apply(pt, torch.from_numpy(x), prng.key(5), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)


def test_conv_padding_refuses_odd_maps():
    from repro_torch.models import lenet as tlenet
    cfg = tlenet.LeNetConfig(conv_padding=((1, 0), (0, 0)))
    with pytest.raises(ValueError, match="not 2x2-poolable"):
        tlenet.feature_sizes(cfg)


def test_accuracy_matches_jax():
    jlenet, tlenet, jcfg, tcfg, pj, pt = _both("VALID")
    from repro_torch.data import synthetic_mnist as tdata
    x, y = tdata.make_dataset(4, seed=5)
    aj = float(jlenet.accuracy(pj, jnp.asarray(x), jnp.asarray(y),
                               jax.random.key(2), jcfg))
    with torch.no_grad():
        at = float(tlenet.accuracy(pt, torch.from_numpy(x),
                                   torch.from_numpy(y), prng.key(2), tcfg))
    assert at == aj


# ---------------------------------------------------------------------------
# The performance model (Table 2)
# ---------------------------------------------------------------------------

def test_perfmodel_matches_jax():
    from repro.core import perfmodel as jpm
    from repro_torch.core import perfmodel as tpm
    for chip_kw in ({}, {"bimodal": True}, {"t_meas_large": 60e-9}):
        tc, jc = tpm.RPUChipSpec(**chip_kw), jpm.RPUChipSpec(**chip_kw)
        for layers in ("alexnet_layers", "lenet_layers"):
            tl, jl = getattr(tpm, layers)(), getattr(jpm, layers)()
            assert [dataclasses.astuple(a) for a in tl] == [
                dataclasses.astuple(b) for b in jl]
            assert [(a.macs, a.effective_ws) for a in tl] == [
                (b.macs, b.effective_ws) for b in jl]
            assert [tpm.layer_time(a, tc) for a in tl] == [
                jpm.layer_time(b, jc) for b in jl]
            assert tpm.image_time_rpu(tl, tc) == jpm.image_time_rpu(jl, jc)
            assert tpm.image_time_conventional(tl, 10e12) == \
                jpm.image_time_conventional(jl, 10e12)
            for n in (2, 3):
                assert [dataclasses.astuple(a) for a in
                        tpm.split_bottleneck(tl, n, tc)] == [
                    dataclasses.astuple(b) for b in
                    jpm.split_bottleneck(jl, n, jc)]


def test_table2_matches_jax(capsys):
    from benchmarks import table2_alexnet as jt2
    from repro_torch.benchmarks import table2_alexnet as tt2
    assert tt2.run(csv=True) == jt2.run(csv=True)
    out = capsys.readouterr().out
    assert out.count("table2_rpu_image,242.000,bottleneck=K1") == 2


# ---------------------------------------------------------------------------
# The committed JAX bands and the band rule
# ---------------------------------------------------------------------------

def test_jax_bands_file_matches_the_runs():
    """Every entry of jax_bands.json names a band run, holds the JAX
    ``_describe`` of that run (and the port's equals it), the band
    protocol and a result for every band seed."""
    from repro.train import cnn as jcnn
    from repro_torch.train import cnn as tcnn
    data = tbands.load()
    assert data["protocol"] == tsuite.BAND_PROTOCOL
    assert set(data["runs"]) == set(tsuite.BAND_RUNS)
    seeds = [str(s) for s in tsuite.BAND_SEEDS]
    for name, entry in data["runs"].items():
        assert entry["config"] == jcnn._describe(_jax_config(name)), name
        assert entry["config"] == tcnn._describe(tsuite.config(name)), name
        assert entry["protocol"] == tsuite.BAND_PROTOCOL
        assert sorted(entry["test_error"]) == sorted(entry["mean_last5"]) \
            == seeds
        for s in seeds:
            errs = entry["test_error"][s]
            assert len(errs) == tsuite.BAND_PROTOCOL["epochs"]
            assert math.isclose(entry["mean_last5"][s],
                                float(np.mean(errs[-5:])), rel_tol=1e-12)
        assert set(entry["versions"]) == {"jax", "numpy"}


def _made_up_bands(means):
    return {"runs": {n: {"mean_last5": {str(i): v for i, v in enumerate(m)}}
                     for n, m in means.items()}}


def test_band_rule_on_made_up_numbers():
    bands = _made_up_bands({"a": [0.10, 0.12, 0.11], "b": [0.02, 0.021,
                                                           0.019],
                            "c": [0.025, 0.03, 0.02]})
    ba = tbands.band(bands["runs"]["a"])
    assert ba["delta"] == pytest.approx(max(np.std([0.10, 0.12, 0.11]),
                                            0.01))
    assert (ba["lo"], ba["hi"]) == pytest.approx((0.10 - ba["delta"],
                                                  0.12 + ba["delta"]))
    # inside both bands, in JAX's order
    v = tbands.decide(("a", "b"), {"a": [0.13, 0.11], "b": [0.02]}, bands)
    assert v["ok"] and v["in_band"] == [True, True] and v["order"] == "a>b"
    # a run outside its band
    v = tbands.decide(("a", "b"), {"a": [0.15, 0.16], "b": [0.02]}, bands)
    assert not v["ok"] and v["in_band"] == [False, True]
    # in the bands, but the order flipped
    wide = _made_up_bands({"a": [0.05, 0.25], "b": [0.01, 0.03]})
    v = tbands.decide(("a", "b"), {"a": [0.01], "b": [0.03]}, wide)
    assert v["in_band"] == [True, True] and v["order"] == "a>b"
    assert not v["order_ok"] and not v["ok"]
    # a tie in JAX (means within delta): the port's two within delta
    v = tbands.decide(("b", "c"), {"b": [0.02], "c": [0.028]}, bands)
    assert v["order"] == "tie" and v["ok"]
    v = tbands.decide(("b", "c"), {"b": [0.011], "c": [0.035]}, bands)
    assert v["order"] == "tie" and not v["order_ok"]
    assert [x["pair"] for x in tbands.decide_all(
        {"a": [0.11], "b": [0.02]}, bands, [("a", "b"), ("a", "z")])] == [
        ["a", "b"]]
    assert "PASS" in tbands.describe(tbands.decide(
        ("a", "b"), {"a": [0.11], "b": [0.02]}, bands))


def _jax_config(name):
    """The JAX package's configuration of a band run."""
    from benchmarks import cnn_suite as jsuite
    from repro.core import device as jdev
    from repro.models.lenet import LeNetConfig as JLeNetConfig
    if name == "nm_bm_two_phase":   # benchmarks/bm_two_phase_check.py
        return JLeNetConfig.uniform(
            dataclasses.replace(jdev.rpu_nm_bm(), bm_mode="two_phase"))
    return jsuite.RUNS[name]()


def _jax_band_run(job):
    """One JAX ``cnn.train`` at the band protocol: ``(name, seed, result)``."""
    from repro.train import cnn as jcnn
    name, seed = job
    r = jcnn.train(_jax_config(name), seed=seed, verbose=False,
                   **tsuite.BAND_PROTOCOL)
    return name, seed, {k: r[k] for k in ("test_error", "mean_last5",
                                          "steps_per_sec", "wallclock_s")}


def write_bands(jobs: int = 4) -> None:
    """Train every band run in the JAX package and write jax_bands.json."""
    import multiprocessing
    from repro.train import cnn as jcnn
    work = [(n, s) for n in tsuite.BAND_RUNS for s in tsuite.BAND_SEEDS]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs) as pool:
        done = []
        for name, seed, r in pool.imap_unordered(_jax_band_run, work):
            print(f"[bands] {name} seed {seed}: mean_last5 "
                  f"{100 * r['mean_last5']:.2f}% ({r['wallclock_s']:.0f}s)",
                  flush=True)
            done.append((name, seed, r))
    versions = {"jax": jax.__version__, "numpy": np.__version__}
    runs = {}
    for name in tsuite.BAND_RUNS:
        mine = sorted((s, r) for n, s, r in done if n == name)
        runs[name] = {
            "config": jcnn._describe(_jax_config(name)),
            "protocol": dict(tsuite.BAND_PROTOCOL),
            "seeds": [s for s, _ in mine],
            "test_error": {str(s): r["test_error"] for s, r in mine},
            "mean_last5": {str(s): r["mean_last5"] for s, r in mine},
            "steps_per_sec": {str(s): r["steps_per_sec"] for s, r in mine},
            "versions": versions,
        }
    with open(tbands.PATH, "w") as f:
        json.dump({"protocol": dict(tsuite.BAND_PROTOCOL),
                   "seeds": list(tsuite.BAND_SEEDS), "versions": versions,
                   "made_by": "python tests/test_torch_figures.py "
                              "--write-bands", "runs": runs}, f, indent=1)
    print(f"[bands] wrote {tbands.PATH}")


if __name__ == "__main__":
    if "--write-bands" not in sys.argv:
        raise SystemExit("usage: test_torch_figures.py --write-bands "
                         "[--jobs N]")
    n_jobs = (int(sys.argv[sys.argv.index("--jobs") + 1])
              if "--jobs" in sys.argv else 4)
    write_bands(n_jobs)
