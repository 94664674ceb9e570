"""Synthetic sequence tasks for the recurrent analog workload.

The port's copy of the JAX package's ``data/sequences.py``: the *delayed
copy* task (the LSTM-on-RPU sequel paper's class of synthetic benchmark).
The network reads ``seq_len`` random symbols, waits through a blank delay
terminated by a GO marker, then must emit the symbols in order.  Numpy's
``default_rng`` draws the symbols exactly as the JAX package does, so both
packages see the same tokens for the same seed.

Token layout (vocab ``V >= 3``):

* ``0`` — BLANK, ``1`` — GO, ``2 .. V-1`` — payload symbols;
* input:  ``[s_0 .. s_{L-1}, BLANK * (delay-1), GO, BLANK * L]``;
* target: ``-1`` (ignored) everywhere except the last ``L`` positions,
  which are ``[s_0 .. s_{L-1}]``.

Total length ``T = 2 * seq_len + delay``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BLANK = 0
GO = 1
SYMBOL_BASE = 2
IGNORE = -1


def copy_task(n: int, seq_len: int = 4, delay: int = 2, vocab: int = 8,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generate ``n`` delayed-copy sequences.

    Returns ``(tokens, targets)``: int32 arrays of shape (n, T) with
    ``targets == IGNORE`` outside the answer span.
    """
    if vocab < SYMBOL_BASE + 1:
        raise ValueError(f"copy task needs vocab >= 3, got {vocab}")
    if delay < 1:
        raise ValueError("delay must be >= 1 (the GO marker needs a slot)")
    rng = np.random.default_rng(seed)
    syms = rng.integers(SYMBOL_BASE, vocab, size=(n, seq_len),
                        dtype=np.int32)
    t_total = 2 * seq_len + delay
    tokens = np.full((n, t_total), BLANK, dtype=np.int32)
    tokens[:, :seq_len] = syms
    tokens[:, seq_len + delay - 1] = GO
    targets = np.full((n, t_total), IGNORE, dtype=np.int32)
    targets[:, seq_len + delay:] = syms
    return tokens, targets


def one_hot_time_major(tokens: np.ndarray, vocab: int,
                       dtype=np.float32) -> np.ndarray:
    """(B, T) int tokens -> (T, B, V) one-hot, the cell's time-major
    layout."""
    b, t = tokens.shape
    x = np.zeros((t, b, vocab), dtype=dtype)
    tt, bb = np.meshgrid(np.arange(t), np.arange(b), indexing="ij")
    x[tt, bb, tokens.T] = 1.0
    return x
