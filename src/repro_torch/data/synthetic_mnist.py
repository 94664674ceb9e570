"""Procedural synthetic MNIST (the fallback when the MNIST files are absent).

Ten digit glyphs are drawn programmatically on a 28x28 canvas (stroke
segments + arcs), then augmented per sample with random shifts, intensity
jitter, stroke smoothing and pixel noise.  The generator is fully
deterministic in its seed, cheap (numpy, build-once), and produces a task a
LeNet solves to <1-2% test error at FP precision — sufficient statistical
headroom to reproduce the paper's *qualitative* ablation structure.

When real MNIST IDX files exist, ``repro_torch.data.mnist`` is preferred.
The same generator as the JAX package's, so both packages train on the
same images from the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_SIZE = 28


def _canvas() -> np.ndarray:
    return np.zeros((_SIZE, _SIZE), dtype=np.float32)


def _line(img: np.ndarray, p0, p1, width: float = 1.6) -> None:
    """Draw an anti-aliased-ish thick segment by dense point sampling."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    n = int(max(2, np.hypot(*(p1 - p0)) * 3))
    ys, xs = np.mgrid[0:_SIZE, 0:_SIZE]
    for t in np.linspace(0.0, 1.0, n):
        c = p0 + t * (p1 - p0)
        d2 = (ys - c[0]) ** 2 + (xs - c[1]) ** 2
        img[:] = np.maximum(img, np.exp(-d2 / (2 * (width / 2) ** 2)))


def _arc(img: np.ndarray, center, radius, a0, a1, width: float = 1.6) -> None:
    n = int(max(4, abs(a1 - a0) * radius * 2))
    ys, xs = np.mgrid[0:_SIZE, 0:_SIZE]
    for a in np.linspace(a0, a1, n):
        cy = center[0] + radius * np.sin(a)
        cx = center[1] + radius * np.cos(a)
        d2 = (ys - cy) ** 2 + (xs - cx) ** 2
        img[:] = np.maximum(img, np.exp(-d2 / (2 * (width / 2) ** 2)))


def _glyph(digit: int) -> np.ndarray:
    """Hand-drawn digit templates, roughly centered, 20x14 core box."""
    g = _canvas()
    pi = np.pi
    if digit == 0:
        _arc(g, (14, 14), 7.5, 0, 2 * pi)
    elif digit == 1:
        _line(g, (5, 15), (23, 15))
        _line(g, (5, 15), (9, 11))
    elif digit == 2:
        _arc(g, (10, 14), 5, -pi, 0.35 * pi)
        _line(g, (11.5, 18), (23, 9))
        _line(g, (23, 9), (23, 20))
    elif digit == 3:
        _arc(g, (10, 13), 4.5, -0.75 * pi, 0.5 * pi)
        _arc(g, (18.5, 13), 4.8, -0.5 * pi, 0.78 * pi)
    elif digit == 4:
        _line(g, (5, 17), (23, 17))
        _line(g, (5, 17), (16, 8))
        _line(g, (16, 8), (16, 22))
    elif digit == 5:
        _line(g, (5, 19), (5, 9))
        _line(g, (5, 9), (13, 9))
        _arc(g, (17, 13), 5.5, -0.55 * pi, 0.8 * pi)
    elif digit == 6:
        _arc(g, (17, 13), 5.5, 0, 2 * pi)
        _arc(g, (12, 16.5), 10.5, 0.62 * pi, 1.05 * pi)
    elif digit == 7:
        _line(g, (5, 8), (5, 20))
        _line(g, (5, 20), (23, 12))
    elif digit == 8:
        _arc(g, (10, 14), 4.3, 0, 2 * pi)
        _arc(g, (18.7, 14), 5.0, 0, 2 * pi)
    elif digit == 9:
        _arc(g, (11, 14), 5.3, 0, 2 * pi)
        _arc(g, (16, 11.5), 10.3, -0.38 * pi, 0.12 * pi)
    return np.clip(g, 0.0, 1.0)


_TEMPLATES: np.ndarray = np.stack([_glyph(d) for d in range(10)])


def _smooth(img: np.ndarray, k: int) -> np.ndarray:
    """k passes of a 3x3 box blur (cheap stroke-thickness variation)."""
    for _ in range(k):
        p = np.pad(img, 1)
        img = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
               p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:] +
               p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0
    return img


def make_dataset(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Generate ``n`` images.  Returns (images (n,28,28,1) in [0,1], labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.empty((n, _SIZE, _SIZE, 1), dtype=np.float32)
    for i in range(n):
        t = _TEMPLATES[labels[i]]
        dy, dx = rng.integers(-4, 5, size=2)
        img = np.roll(np.roll(t, dy, axis=0), dx, axis=1)
        img = _smooth(img, int(rng.integers(0, 4)))
        img = img * rng.uniform(0.55, 1.30)
        if rng.random() < 0.5:                       # random occlusion patch
            oy, ox = rng.integers(0, _SIZE - 6, size=2)
            img[oy:oy + 6, ox:ox + 6] = 0.0
        img = img + rng.normal(0.0, 0.15, img.shape).astype(np.float32)
        images[i, :, :, 0] = np.clip(img, 0.0, 1.0)
    return images, labels


def load_splits(n_train: int = 8192, n_test: int = 2048, seed: int = 0):
    """Disjoint train/test RNG streams."""
    xtr, ytr = make_dataset(n_train, seed=seed * 2 + 1)
    xte, yte = make_dataset(n_test, seed=seed * 2 + 2)
    return (xtr, ytr), (xte, yte)
