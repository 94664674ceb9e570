"""The port's token pipeline (``repro_torch.data.tokens``) against the JAX
package's (``repro.data.tokens``): numpy on both sides, so every batch is
bitwise equal."""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.data import tokens as J
from repro_torch.data import tokens as T


@pytest.mark.parametrize("host_index", [0, 1])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_are_jax_bits(seed, host_index):
    kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=seed,
              host_index=host_index, host_count=2)
    js = J.SyntheticTokenSource(J.TokenPipelineConfig(**kw))
    ts = T.SyntheticTokenSource(T.TokenPipelineConfig(**kw))
    for step in range(4):
        a, b = js.batch_at(step), ts.batch_at(step)
        assert a.dtype == b.dtype == np.int32 and a.shape == (4, 33)
        np.testing.assert_array_equal(a, b)
    first = next(iter(ts))
    np.testing.assert_array_equal(first, js.batch_at(0))


def test_hash_is_jax_bits():
    x = np.arange(0, 1 << 20, 977, dtype=np.uint32)
    np.testing.assert_array_equal(J._hash_uniform(x, np.uint32(3)),
                                  T._hash_uniform(x, np.uint32(3)))


def test_zipf_marginal_prefers_low_ranks():
    ts = T.SyntheticTokenSource(T.TokenPipelineConfig(
        vocab=256, seq_len=128, global_batch=8))
    toks = np.concatenate([ts.batch_at(s).ravel() for s in range(4)])
    assert toks.min() >= 0 and toks.max() < 256
    assert np.mean(toks < 16) > 0.5


def test_file_source_is_jax_bits(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(vocab=60000, seq_len=32, global_batch=4, host_index=1,
              host_count=2)
    js = J.FileTokenSource(str(path), J.TokenPipelineConfig(**kw))
    ts = T.FileTokenSource(str(path), T.TokenPipelineConfig(**kw))
    for step in (0, 1, 38, 39, 40):          # 39 steps in the file: wraps
        np.testing.assert_array_equal(js.batch_at(step), ts.batch_at(step))
