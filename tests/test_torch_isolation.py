"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walker_sees_forbidden_imports(tmp_path):
    """The checker itself flags each import form."""
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import tile\n"
                 "import importlib\nimportlib.import_module('repro.x')\n"
                 "from repro_torch.utils import prng\n")
    mods = [m.split(".")[0] for m in _imported_modules(p)]
    assert mods.count("jax") == 1 and mods.count("repro") == 2


def test_covers_every_package_of_the_port():
    """Every package of the port, the figure suite's and the checkpoint
    store's included, is walked."""
    pkgs = {p.parent.name for p in FILES if p.name == "__init__.py"}
    assert {"benchmarks", "core", "kernels", "train", "models",
            "checkpoint", "distributed"} <= pkgs
    walked = {(p.parent.name, p.name) for p in FILES}
    assert {("checkpoint", "store.py"), ("distributed", "fault.py")} <= walked
    names = {p.name for p in FILES if p.parent.name == "benchmarks"}
    assert {"cnn_suite.py", "bands.py", "table2_alexnet.py"} <= names


def test_walks_the_tile_grid():
    """The crossbar tile grid module (core/tile_grid.py) is walked."""
    assert ROOT / "src" / "repro_torch" / "core" / "tile_grid.py" in FILES


def test_walks_the_recurrent_cells_and_the_entry_points():
    """The recurrent package, the sequence data, the LSTM figure and the
    training and serving entry points are walked."""
    walked = {(p.parent.name, p.name) for p in FILES}
    assert {("recurrent", n) for n in ("__init__.py", "cell.py",
                                       "temporal.py", "oracle.py",
                                       "model.py")} <= walked
    assert {("launch", "train.py"), ("launch", "serve.py"),
            ("data", "sequences.py"),
            ("benchmarks", "lstm_management.py")} <= walked
