"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  The
build runs at first use (never at import), lands in ``build/repro_torch``
at the root of the source checkout (listed in ``.gitignore``; override with
``REPRO_TORCH_BUILD_DIR``), and is keyed by a hash of the sources and flags
so an edited source rebuilds.  :func:`build_all` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("noisy_mvm", "managed_mvm", "conv_mvm", "pulse_counts",
           "pulse_update", "bwd_update_mvm", "flash_attention",
           "key_schedule")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, library
    path, log file), or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, tmp, out, log


def _finish(name: str, started) -> None:
    proc, tmp, out, log = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n{text}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel source in parallel; returns the library
    paths.  Already-built libraries are reused."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return {n: _lib_path(n) for n in names}


def build_log(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the last build of ``name``."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
