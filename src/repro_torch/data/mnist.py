"""MNIST IDX reader with the procedural fallback.

Reads the canonical IDX files (``train-images-idx3-ubyte`` etc., raw or
``.gz``) from ``$REPRO_MNIST_DIR`` or ``./data/mnist`` when all four are
present; otherwise falls back to :mod:`repro_torch.data.synthetic_mnist`
and says so.  Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _find(directory: str, base: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(directory, base + suffix)
        if os.path.exists(p):
            return p
    return None


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"bad IDX magic in {path}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(shape)


def mnist_dir() -> str:
    return os.environ.get("REPRO_MNIST_DIR", os.path.join("data", "mnist"))


def available() -> bool:
    d = mnist_dir()
    return all(_find(d, b) is not None for b in _FILES.values())


def load_splits(n_train: Optional[int] = None, n_test: Optional[int] = None,
                seed: int = 0, verbose: bool = True):
    """(train_x, train_y), (test_x, test_y); images (N, 28, 28, 1) float32
    in [0, 1], labels int32."""
    if available():
        d = mnist_dir()
        arrays = {k: _read_idx(_find(d, b)) for k, b in _FILES.items()}
        xtr = (arrays["train_images"].astype(np.float32) / 255.0)[..., None]
        xte = (arrays["test_images"].astype(np.float32) / 255.0)[..., None]
        ytr = arrays["train_labels"].astype(np.int32)
        yte = arrays["test_labels"].astype(np.int32)
        if n_train:
            xtr, ytr = xtr[:n_train], ytr[:n_train]
        if n_test:
            xte, yte = xte[:n_test], yte[:n_test]
        if verbose:
            print(f"[data] real MNIST from {d}: {len(xtr)} train / "
                  f"{len(xte)} test")
        return (xtr, ytr), (xte, yte)

    from repro_torch.data import synthetic_mnist
    if verbose:
        print("[data] real MNIST not found -> procedural synthetic MNIST")
    return synthetic_mnist.load_splits(n_train or 8192, n_test or 2048, seed)
