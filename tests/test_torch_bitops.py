"""The port's packed bit-matrix primitives (`ops/bitops.py`) against the JAX
package's: bit-identical on numpy-seeded matrices (integers, no tolerance).
The port holds the uint32 words of a device tensor as int32 bit patterns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops import bitops as jax_bitops
from qiskit_gym_torch.ops import (bit_transpose, bitops, pack_bits,
                                  packed_identity, unpack_bits)

DIMS = [5, 32, 54, 70]


def _bits(dim, seed=0):
    return np.random.default_rng(seed).integers(0, 2, (dim, dim))


def _as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("dim", DIMS)
def test_pack_and_unpack_match_jax(dim):
    m = _bits(dim)
    packed = pack_bits(m)
    want = jax_bitops.pack_bits(m)
    assert packed.dtype == np.uint32 and packed.shape == want.shape
    np.testing.assert_array_equal(packed, want)
    assert bitops.words_for(dim) == jax_bitops.words_for(dim)
    assert bitops.padded_rows(dim) == jax_bitops.padded_rows(dim)
    words = bitops.to_words(packed)
    assert words.dtype == torch.int32
    back = unpack_bits(words, dim)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_bitops.unpack_bits(jnp.asarray(want),
                                                        dim)))
    np.testing.assert_array_equal(back.numpy(), m)
    np.testing.assert_array_equal(packed_identity(dim),
                                  jax_bitops.packed_identity(dim))


@pytest.mark.parametrize("dim", DIMS)
def test_bit_transpose_matches_jax_and_the_dense_transpose(dim):
    m = _bits(dim, seed=1)
    packed = pack_bits(m)
    got = bit_transpose(bitops.to_words(packed))
    np.testing.assert_array_equal(
        _as_u32(got), np.asarray(jax_bitops.bit_transpose(
            jnp.asarray(packed))))
    np.testing.assert_array_equal(unpack_bits(got, dim).numpy(), m.T)
    # an involution, and batched over leading axes
    assert torch.equal(bit_transpose(got), bitops.to_words(packed))
    batch = np.stack([packed, pack_bits(m.T), packed_identity(dim)])
    np.testing.assert_array_equal(
        _as_u32(bit_transpose(bitops.to_words(batch))),
        np.asarray(jax_bitops.bit_transpose(jnp.asarray(batch))))


def test_popcount_matches_jax_on_every_bit_pattern_edge():
    rng = np.random.default_rng(2)
    words = np.concatenate([
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA],
                 np.uint32),
        rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)])
    got = bitops.popcount(bitops.to_words(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_bitops.popcount(jnp.asarray(words))))
    np.testing.assert_array_equal(
        got.numpy(), [bin(int(w)).count("1") for w in words])
