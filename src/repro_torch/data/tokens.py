"""Deterministic, resumable LM token pipeline (numpy only), the JAX
package's ``data/tokens.py`` bit for bit.

Synthetic Zipf-distributed token streams generated from a counter-based hash
of ``(seed, step, position)``, so:

  * any step's batch is reproducible from its index alone (exact resume
    after preemption: the checkpoint stores just the step counter);
  * each data-parallel host generates only its own shard (no host fan-out);
  * there is no filesystem dependency in tests, while ``FileTokenSource``
    reads memory-mapped pre-tokenised corpora.

The batches are host arrays; the trainer copies each into a static device
buffer (``train/engine.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    host_index: int = 0
    host_count: int = 1


class SyntheticTokenSource:
    """Zipf tokens from a counter hash: O(1) state, exact seek."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.host_count == 0
        self.per_host = cfg.global_batch // cfg.host_count
        # inverse-CDF table of the Zipf marginal
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        probs /= probs.sum()
        self._cdf = np.cumsum(probs)

    def batch_at(self, step: int) -> np.ndarray:
        """(per_host_batch, seq_len) int32 for this host at this step."""
        cfg = self.cfg
        n = self.per_host * cfg.seq_len
        base = (np.uint64(step) * np.uint64(cfg.global_batch * cfg.seq_len)
                + np.uint64(cfg.host_index * n))
        idx = (base + np.arange(n, dtype=np.uint64)).astype(np.uint32)
        u = _hash_uniform(idx, np.uint32(cfg.seed))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        return toks.reshape(self.per_host, cfg.seq_len)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokenSource:
    """Memory-mapped pre-tokenised corpus (uint16/uint32 flat file)."""

    def __init__(self, path: str, cfg: TokenPipelineConfig,
                 dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.per_host = cfg.global_batch // cfg.host_count
        self._stride = self.per_host * cfg.seq_len
        self._n_steps = (len(self.data) - 1) // (
            cfg.global_batch * cfg.seq_len)

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        step = step % max(1, self._n_steps)
        base = step * cfg.global_batch * cfg.seq_len \
            + cfg.host_index * self._stride
        flat = np.asarray(self.data[base:base + self._stride])
        return flat.reshape(self.per_host, cfg.seq_len).astype(np.int32)


def _hash_uniform(x: np.ndarray, seed: np.uint32) -> np.ndarray:
    """A uint32 counter hash to uniforms in [0, 1) (24 bits)."""
    x = (x ^ seed).astype(np.uint32)
    x = (x + np.uint32(0x9E3779B9))
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x21F0AAAD)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x735A2D97)
    x = x ^ (x >> np.uint32(15))
    return (x >> np.uint32(8)).astype(np.float64) / float(1 << 24)
