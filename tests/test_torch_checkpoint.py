"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
the JAX package's (``repro.checkpoint.store``).

The same tree saved by both stores gives byte-identical leaf files and the
same ``index.json`` apart from ``time`` and ``treedef_repr`` (free text in
both); each store reads what the other wrote; a JAX LeNet checkpoint
restores into the port bitwise equal to ``from_jax_params`` of the same
parameters, seeds included.  The rest ports the JAX store's own tests
(``tests/test_checkpoint.py``, ``tests/test_checkpoint_properties.py``),
with the port's form of the donated-buffer fault: an in-place update right
after an async save must not reach the checkpoint being written.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analog import presets as jpresets
from repro.checkpoint import store as jstore
from repro.models import lenet as jlenet
from repro_torch.analog import presets as tpresets
from repro_torch.analog.convert import from_jax_params
from repro_torch.checkpoint import store
from repro_torch.models import lenet as tlenet
from repro_torch.utils import prng


def _arrays():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32))


def _jax_tree():
    w, b = _arrays()
    return {"w": jnp.asarray(w), "b16": jnp.asarray(b, jnp.bfloat16),
            "nested": {"count": jnp.asarray(7, jnp.int32),
                       "key": jax.random.key(3)},
            "steps": [jnp.arange(4, dtype=jnp.int32)]}


def _port_tree():
    w, b = _arrays()
    return {"w": torch.from_numpy(w),
            "b16": torch.from_numpy(b).to(torch.bfloat16),
            "nested": {"count": torch.tensor(7, dtype=torch.int32),
                       "key": prng.key(3)},
            "steps": [torch.arange(4, dtype=torch.int32)]}


def _index(path):
    with open(os.path.join(path, "index.json")) as f:
        return json.load(f)


def _without_free_text(index):
    return {k: v for k, v in index.items()
            if k not in ("time", "treedef_repr")}


def test_leaf_files_and_index_match_the_jax_store(tmp_path):
    pj = jstore.save(str(tmp_path / "jax"), 5, _jax_tree(), {"note": "x"})
    pt = store.save(str(tmp_path / "port"), 5, _port_tree(), {"note": "x"})
    ij, it = _index(pj), _index(pt)
    assert _without_free_text(it) == _without_free_text(ij)
    assert [e["key"] for e in it["leaves"]] == [
        "b16", "nested/count", "nested/key", "steps/0", "w"]
    for e in ij["leaves"]:
        with open(os.path.join(pj, e["file"]), "rb") as f:
            want = f.read()
        with open(os.path.join(pt, e["file"]), "rb") as f:
            assert f.read() == want, e["key"]


def test_each_store_reads_the_other(tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jd, 1, _jax_tree())
    store.save(td, 1, _port_tree())
    w, b = _arrays()

    got, _ = jstore.restore(td, 1, _jax_tree())
    np.testing.assert_array_equal(np.asarray(got["w"]), w)
    assert got["b16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b16"], np.float32),
                                  np.asarray(jnp.asarray(b, jnp.bfloat16),
                                             np.float32))
    assert int(got["nested"]["count"]) == 7
    np.testing.assert_array_equal(jax.random.key_data(got["nested"]["key"]),
                                  jax.random.key_data(jax.random.key(3)))

    got, _ = store.restore(jd, 1, _port_tree())
    want = _port_tree()
    assert torch.equal(got["w"], want["w"])
    assert got["b16"].dtype == torch.bfloat16
    assert torch.equal(got["b16"], want["b16"])
    assert got["nested"]["count"].dtype == torch.int32
    assert int(got["nested"]["count"]) == 7
    assert got["nested"]["key"] == prng.key(3)
    assert torch.equal(got["steps"][0], want["steps"][0])


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


PAPER = ("K2=k2_multi_device:use_pallas=true:bm_mode=two_phase"
         ":fuse_bwd_update=true,*=managed:use_pallas=true"
         ":bm_mode=two_phase:fuse_bwd_update=true")
# the JAX package's configs of the same device settings: (jax, port)
LENET_CONFIGS = {
    "digital": (lambda: jlenet.LeNetConfig(mode="digital"),
                lambda: tlenet.LeNetConfig(mode="digital")),
    "policy": (lambda: jlenet.LeNetConfig.from_policy(
                   jpresets.parse_policy("K2=rpu_baseline,*=managed")),
               lambda: tlenet.LeNetConfig.from_policy(
                   tpresets.parse_policy("K2=rpu_baseline,*=managed"))),
    "paper": (lambda: jlenet.LeNetConfig.from_policy(jpresets.parse_policy(
                  "K2=k2_multi_device:bm_mode=two_phase,"
                  "*=managed:bm_mode=two_phase")),
              lambda: tlenet.LeNetConfig.from_policy(
                  tpresets.parse_policy(PAPER))),
}
K2_MAPS = {"digital": (32, 401), "policy": (32, 401), "paper": (416, 401)}


@pytest.mark.parametrize("name", list(LENET_CONFIGS))
def test_jax_lenet_checkpoint_restores_into_the_port(tmp_path, name):
    jcfg, tcfg = (f() for f in LENET_CONFIGS[name])
    pj = jlenet.init(jax.random.key(0), jcfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jdir, 1, (pj, ()), {"epoch": 1})

    like = tlenet.init(prng.key(1), tcfg, device="cpu")
    (got, opt_state), meta = store.restore(jdir, 1, (like, ()))
    assert opt_state == () and meta == {"epoch": 1}
    want = from_jax_params(_numpy_tree(pj), device="cpu")
    for layer in tlenet.LAYERS:
        g, w = got[layer], want[layer]
        assert g.meta is like[layer].meta
        assert torch.equal(g.w, w.w), layer
        for f in ("dw_up", "dw_dn", "bound"):
            assert torch.equal(getattr(g.maps, f), getattr(w.maps, f))
        assert g.seed == w.seed, layer
    assert tuple(got["K2"].maps.shape) == K2_MAPS[name]

    store.save(tdir, 1, (tlenet.init(prng.key(0), tcfg, device="cpu"), ()))
    leaf_list = [(e["key"], e["shape"], e["dtype"], e["is_key"])
                 for e in _index(os.path.join(tdir, "step_0000000001"))[
                     "leaves"]]
    assert leaf_list == [(e["key"], e["shape"], e["dtype"], e["is_key"])
                         for e in _index(os.path.join(
                             jdir, "step_0000000001"))["leaves"]]
    assert len(leaf_list) == 20 and leaf_list[4] == (
        "0/K1/2", [], "key<fry>", True)


def test_restore_rejects_another_structure(tmp_path):
    store.save(str(tmp_path), 1, _port_tree())
    like = _port_tree()
    like["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 1, like)
    like = _port_tree()
    del like["steps"]
    with pytest.raises(ValueError, match="5 leaves"):
        store.restore(str(tmp_path), 1, like)


def test_restore_lands_on_the_device_asked_for(tmp_path):
    store.save(str(tmp_path), 1, _port_tree())
    got, _ = store.restore(str(tmp_path), 1, _port_tree(), device="cpu")
    assert got["w"].device == torch.device("cpu")
    # a numpy leaf in ``like`` restores as a CPU tensor
    like = {"w": np.zeros((3, 4), np.float32)}
    store.save(str(tmp_path), 2, {"w": _port_tree()["w"]})
    got, _ = store.restore(str(tmp_path), 2, like)
    assert torch.equal(got["w"], _port_tree()["w"])


# --- the JAX store's own tests, on the port -------------------------------

def test_latest_step_ignores_partial(tmp_path):
    t = _port_tree()
    store.save(str(tmp_path), 1, t)
    store.save(str(tmp_path), 2, t)
    # a crashed save
    os.makedirs(tmp_path / "step_0000000003.tmp")
    os.makedirs(tmp_path / "step_0000000004")   # no index.json
    assert store.latest_step(str(tmp_path)) == 2


def test_checksum_detects_corruption(tmp_path):
    t = _port_tree()
    path = store.save(str(tmp_path), 1, t)
    with open(os.path.join(path, "leaf_00000.npy"), "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\xff")
    with pytest.raises(IOError):
        store.restore(str(tmp_path), 1, t)


def test_async_checkpointer_and_retention(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _port_tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    ck.wait()
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_0000000003", "step_0000000004"]
    assert store.latest_step(str(tmp_path)) == 4


def test_async_save_copies_before_an_in_place_update(tmp_path, monkeypatch):
    """On the CPU ``t.cpu()`` is ``t``: without the host copy taken by
    ``save``, the next step's ``w.add_`` (here while the write is held
    open) would reach the checkpoint.  The metadata list is copied too."""
    monkeypatch.setenv("REPRO_CKPT_WRITE_DELAY", "0.05")
    w = torch.zeros(8, 8)
    history = [0.5]
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": w, "seed": prng.key(7)}, {"history": history})
    w.add_(1)
    history.append(0.25)
    ck.wait()
    got, meta = store.restore(str(tmp_path), 1,
                              {"w": torch.ones(8, 8), "seed": prng.key(0)})
    assert torch.equal(got["w"], torch.zeros(8, 8))
    assert got["seed"] == prng.key(7)
    assert meta["history"] == [0.5]


def test_async_save_removes_stale_partials(tmp_path):
    os.makedirs(tmp_path / "step_0000000002.tmp")
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save(1, _port_tree())
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]


def test_latest_step_empty_and_missing(tmp_path):
    assert store.latest_step(str(tmp_path)) is None
    assert store.latest_step(str(tmp_path / "nope")) is None
