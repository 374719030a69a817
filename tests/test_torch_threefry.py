"""The threefry twin (`tfhe_tpu_torch/threefry.py`) against `jax.random`.

The seeded wire formats expand their masks from threefry keys; these tests
pin the twin's bits, splits and the Random123 known-answer vectors to the
JAX this repository runs (partitionable threefry, which the test asserts
and does not set).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.numeric import rand_uniform_torus32
from tfhe_tpu_torch import threefry

torch.set_num_threads(2)

# Random123's known-answer vectors for threefry2x32 with 20 rounds, which
# jax reproduces: (key, counter) -> output.
KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def test_jax_uses_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("key,counter,want", KAT)
def test_known_answer_vectors(key, counter, want):
    x0, x1 = (torch.tensor([c], dtype=torch.int64) for c in counter)
    got = threefry.threefry2x32(key, x0, x1)
    assert (int(got[0]), int(got[1])) == want
    from jax._src import prng

    ref = prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                             jnp.asarray(counter, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(ref)) == want


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 7), (70001,)])
@pytest.mark.parametrize("seed", [0, 2**32 - 1])
def test_random_bits_equal_jax(shape, seed):
    data = np.asarray([seed, 12345], np.uint32)
    key = jax.random.wrap_key_data(jnp.asarray(data))
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = threefry.random_bits(torch.from_numpy(data), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    torus = threefry.uniform_torus32(torch.from_numpy(data), shape)
    np.testing.assert_array_equal(
        torus.numpy(), np.asarray(rand_uniform_torus32(key, shape)))


@pytest.mark.parametrize("num", [2, 7])
def test_split_equals_jax(num):
    legacy = jax.random.PRNGKey(42)  # raw uint32[2] key data
    want = np.asarray(jax.random.split(legacy, num))
    got = threefry.split(torch.from_numpy(np.array(legacy)), num)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    typed = jax.random.wrap_key_data(jnp.asarray(want[1]))
    np.testing.assert_array_equal(
        threefry.split(got[1], 3).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(typed, 3))))


def test_key_from_generator():
    g = torch.Generator().manual_seed(5)
    key = threefry.key_from_generator(g)
    assert key.dtype == torch.uint32 and tuple(key.shape) == (2,)
    words = threefry.key_words(key)
    np.testing.assert_array_equal(
        threefry.random_bits(key, (9,)).numpy(),
        np.asarray(jax.random.bits(
            jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32)), (9,),
            jnp.uint32)).astype(np.int64))


@pytest.mark.cuda
def test_card_bits_equal_cpu_bits():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    key = torch.tensor([7, 2**32 - 3], dtype=torch.int64).to(torch.uint32)
    shape = (4, 1000)
    assert torch.equal(threefry.random_bits(key.cuda(), shape).cpu(),
                       threefry.random_bits(key, shape))
    assert torch.equal(threefry.split(key.cuda(), 5).cpu(),
                       threefry.split(key, 5))
