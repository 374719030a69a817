"""The port's keyswitch key and keyswitch equal the reference's
(`tfhe_tpu/keyswitch.py`), with the same injected randomness."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import keyswitch as j_ks
from tfhe_tpu import lwe as j_lwe
from tfhe_tpu_torch import keyswitch as p_ks
from tfhe_tpu_torch import lwe as p_lwe

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def make_keys(n_in, n_out, l, b, seed):
    rng = np.random.default_rng(seed)
    in_key = rng.integers(0, 2, (n_in,)).astype(np.int32)
    out_key = rng.integers(0, 2, (n_out,)).astype(np.int32)
    a = words(rng, ((1 << b) - 1, l, n_in, n_out))
    noise = rng.integers(-5000, 5000, ((1 << b) - 1, l, n_in)).astype(np.int32)
    ref = j_ks.keyswitch_key_core(jnp.asarray(in_key), jnp.asarray(out_key),
                                  jnp.asarray(a), jnp.asarray(noise), l, b,
                                  noise_stddev=2.0**-15)
    got = p_ks.keyswitch_key_core(torch.from_numpy(in_key),
                                  torch.from_numpy(out_key),
                                  torch.from_numpy(a), torch.from_numpy(noise),
                                  l, b, noise_stddev=2.0**-15)
    return rng, ref, got


@pytest.mark.parametrize("n_in,n_out,l,b", [(64, 16, 8, 2), (48, 10, 4, 4)])
def test_keyswitch_key_core(n_in, n_out, l, b):
    _, ref, got = make_keys(n_in, n_out, l, b, seed=n_in)
    np.testing.assert_array_equal(got.table_limbs.numpy(),
                                  np.asarray(ref.table_limbs))
    assert (got.n_in, got.n_out, got.decomp_length, got.log2_base,
            got.noise_stddev) == (ref.n_in, ref.n_out, ref.decomp_length,
                                  ref.log2_base, ref.noise_stddev)


@pytest.mark.parametrize("n_in,n_out,l,b", [(64, 16, 8, 2), (48, 10, 4, 4)])
def test_keyswitch(n_in, n_out, l, b):
    rng, ref, got = make_keys(n_in, n_out, l, b, seed=n_in + 1)
    a = words(rng, (3, 2, n_in))
    a[0, 0, :3] = [-(2**31), 2**31 - 1, 0]
    bb = words(rng, (3, 2))
    cv = np.full((3, 2), 3e-6, np.float32)
    want = j_ks.keyswitch(ref, j_lwe.LweSample(jnp.asarray(a), jnp.asarray(bb),
                                               jnp.asarray(cv)))
    out = p_ks.keyswitch(got, p_lwe.LweSample(torch.from_numpy(a),
                                              torch.from_numpy(bb),
                                              torch.from_numpy(cv)))
    np.testing.assert_array_equal(out.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(out.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(out.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    np.testing.assert_array_equal(
        p_ks.keyswitch_onehot(torch.from_numpy(a), l, b).numpy(),
        np.asarray(j_ks.keyswitch_onehot(jnp.asarray(a), l, b)))
