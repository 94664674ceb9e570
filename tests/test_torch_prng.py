"""Parity of the port's host-side threefry key schedule and counter-hash RNG
with ``jax.random`` and ``repro.utils.fastrng``.

Keys, seeds, hash words and uniforms are integer-valued stages and must
agree bitwise.  ``normal`` goes through float32 ``log``/``cos``/``sqrt``,
whose results may differ by a few ulp between torch and XLA on the CPU; it
is held at 2e-6 absolute (|z| < 6, so that is a few ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.utils import fastrng as jfastrng
from repro_torch.utils import fastrng, prng

NORMAL_ATOL = 2e-6

_RNG = np.random.default_rng(20260)
SEEDS = [0, 1, 7, 2 ** 31 - 1, -1, -(2 ** 31)] + [
    int(s) for s in _RNG.integers(-(2 ** 31), 2 ** 31, 6)]
DATA = [0, 1, 3, 203, 1 << 20, 2 ** 32 - 1] + [
    int(d) for d in _RNG.integers(0, 2 ** 32, 4)]


def _jkey(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    assert prng.key(seed) == _jkey(jax.random.key(seed))
    np.testing.assert_array_equal(
        prng.key_data(prng.key(seed)),
        np.asarray(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_split_matches_jax(seed, n):
    ks = jax.random.split(jax.random.key(seed), n)
    want = [tuple(int(v) for v in r)
            for r in np.asarray(jax.random.key_data(ks))]
    assert prng.split(prng.key(seed), n) == want


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_fold_in_matches_jax(seed):
    for d in DATA:
        got = prng.fold_in(prng.key(seed), d)
        assert got == _jkey(jax.random.fold_in(jax.random.key(seed), d)), d


def test_nested_schedule_and_key_to_seed_match_jax():
    """The serving schedule: fold_in(step) -> fold_in(layer) -> split(3)
    -> split(2) -> key_to_seed, against the JAX package bitwise."""
    jk, tk = jax.random.key(1), prng.key(1)
    for step in (0, 5):
        js = jax.random.fold_in(jk, (1 << 20) + step)
        ts = prng.fold_in(tk, (1 << 20) + step)
        for li in (0, 29):
            jl = jax.random.split(jax.random.fold_in(js, li), 3)[2]
            tl = prng.split(prng.fold_in(ts, li), 3)[2]
            j1, j2 = jax.random.split(jax.random.split(jl, 3)[0])
            t1, t2 = prng.split(prng.split(tl, 3)[0])
            assert fastrng.key_to_seed(t1) == int(jfastrng.key_to_seed(j1))
            assert fastrng.key_to_seed(t2) == int(jfastrng.key_to_seed(j2))


def test_from_key_data_roundtrip():
    k = prng.fold_in(prng.key(3), 11)
    assert prng.from_key_data(prng.key_data(k)) == k


def test_key_rejects_non_int32_seed():
    with pytest.raises(OverflowError):
        prng.key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_bitwise(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    shape = (7, 33)
    np.testing.assert_array_equal(
        fastrng.bits(tk, shape).numpy().astype(np.uint32),
        np.asarray(jfastrng.bits(jk, shape)))
    np.testing.assert_array_equal(
        fastrng.uniform(tk, shape).numpy(),
        np.asarray(jfastrng.uniform(jk, shape)))


@pytest.mark.parametrize("offset", [0, 5, 2 ** 32 - 3])
def test_uniform_offset_bitwise(offset):
    jk, tk = jax.random.key(9), prng.key(9)
    np.testing.assert_array_equal(
        fastrng.uniform(tk, (4, 16), offset=offset).numpy(),
        np.asarray(jfastrng.uniform(jk, (4, 16), offset=offset)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_matches_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    got = fastrng.normal(tk, (64, 129)).numpy()
    want = np.asarray(jfastrng.normal(jk, (64, 129)))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)


def test_normal_offset_total_chunks():
    """Row chunks drawn with offset/total equal the full draw's rows (the
    port against itself bitwise, and against the JAX package)."""
    tk, jk = prng.key(4), jax.random.key(4)
    full = fastrng.normal(tk, (12, 40)).numpy()
    for r0 in (0, 5, 9):
        chunk = fastrng.normal(tk, (3, 40), offset=r0 * 40, total=12 * 40)
        np.testing.assert_array_equal(chunk.numpy(), full[r0:r0 + 3])
        want = jfastrng.normal(jk, (3, 40), offset=r0 * 40, total=12 * 40)
        np.testing.assert_allclose(chunk.numpy(), np.asarray(want), rtol=0,
                                   atol=NORMAL_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0)],
                         ids=["-2..2", "-1..3"])
def test_truncated_normal_matches_jax(seed, bounds):
    """``jax.random.truncated_normal`` (the readout's init in the JAX
    package's ``dense_init``): within NORMAL_ATOL (the erf of the bounds
    in float64, XLA's float32 erfinv) and inside the open interval."""
    lo, hi = bounds
    got = prng.truncated_normal(prng.key(seed), lo, hi, (33, 77))
    want = np.asarray(jax.random.truncated_normal(
        jax.random.key(seed), lo, hi, (33, 77), jax.numpy.float32))
    assert got.dtype == np.float32 and got.shape == (33, 77)
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    assert (got > lo).all() and (got < hi).all()
