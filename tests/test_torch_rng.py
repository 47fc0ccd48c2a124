"""The port's counter-based RNG and TEA hash against mitsuba_tpu.core.rng:
bitwise.

The port keeps uint32 words in int64 tensors (PyTorch has no uint32
arithmetic on the CPU); these tests hold every word and every float it
draws to the JAX package's bits, including lanes near 2^32.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu_torch.core import rng as trng


def _words(n, seed):
    r = np.random.default_rng(seed)
    w = r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 2**32 - 2, 2**32 - 1]
    return w


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1, 123456789])
def test_threefry2x32_bitwise(seed):
    c0 = _words(4096, 11)
    c1 = _words(4096, 12)
    j0, j1 = jrng.threefry2x32(
        jnp.uint32(seed), jnp.uint32(0x9E3779B9), jnp.asarray(c0), jnp.asarray(c1)
    )
    t0, t1 = trng.threefry2x32(seed, 0x9E3779B9, _t(c0), _t(c1))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))
    assert int(t0.min()) >= 0 and int(t0.max()) < 2**32


def test_uniform_from_bits_bitwise():
    bits = _words(8192, 3)
    ju = np.asarray(jrng.uniform_from_bits(jnp.asarray(bits)))
    tu = trng.uniform_from_bits(_t(bits)).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    assert tu.min() >= 0.0 and tu.max() < 1.0


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_next_2d_stream_bitwise(seed):
    """The first 16 next_2d draws of RNG(seed, lane), lanes near 2^32
    included, and a next_1d after them."""
    lanes = _words(2048, seed % 1000 + 5)
    lanes[4:8] = [2**32 - 3, 2**32 - 4, 2**31, 2**31 - 1]
    jr = jrng.RNG(seed, jnp.asarray(lanes))
    tr = trng.RNG(seed, _t(lanes))
    for _ in range(16):
        ja, jb, jr = jr.next_2d()
        ta, tb, tr = tr.next_2d()
        np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))
        np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb).view(np.uint32))
    assert tr.dim == int(jr.dim) == 32
    ja, jr = jr.next_1d()
    ta, tr = tr.next_1d()
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))


def test_unported_rng_modes_raise():
    lane = torch.arange(4)
    with pytest.raises(NotImplementedError):
        trng.RNG(0, lane, pixel=lane, sidx=lane, lds=True)
    with pytest.raises(NotImplementedError):
        trng.RNG(0, lane, pixel=lane, sidx=lane, oa=3)


@pytest.mark.parametrize("rounds", [4, 8])
def test_sample_tea_32_bitwise(rounds):
    """The TEA hash that derives the gradient pass's seed, on int64 tensors
    of uint32 words and on Python ints."""
    v0, v1 = _words(4096, 21), _words(4096, 22)
    ja, jb = jrng.sample_tea_32(jnp.asarray(v0), jnp.asarray(v1), rounds)
    ta, tb = trng.sample_tea_32(_t(v0), _t(v1), rounds)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))
    for a, b in ((0, 1), (2**32 - 1, 1), (12345, 2**32 - 1)):
        want = jrng.sample_tea_32(jnp.uint32(a), jnp.uint32(b), rounds)
        assert trng.sample_tea_32(a, b, rounds) == tuple(int(x) for x in want)
