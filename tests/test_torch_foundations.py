"""The port's foundations equal the reference's, word for word.

Presets, torus numerics, polynomials, limb splits, the LWE/TLWE/TGSW cores
with injected randomness, the gadget decomposition and the noise model of
`tfhe_tpu_torch` against `tfhe_tpu`, on the CPU at toy sizes. Inputs come
from a numpy seed; ciphertext and key words must be equal, the float32
`cv` agrees to rtol 1e-6 (XLA and torch may order float ops differently).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import lwe as j_lwe
from tfhe_tpu import noise as j_noise
from tfhe_tpu import numeric as j_num
from tfhe_tpu import polynomial as j_poly
from tfhe_tpu import tgsw as j_tgsw
from tfhe_tpu import tlwe as j_tlwe
from tfhe_tpu.ops import conv as j_conv
from tfhe_tpu_torch import lwe as p_lwe
from tfhe_tpu_torch import noise as p_noise
from tfhe_tpu_torch import numeric as p_num
from tfhe_tpu_torch import polynomial as p_poly
from tfhe_tpu_torch import tgsw as p_tgsw
from tfhe_tpu_torch import tlwe as p_tlwe
from tfhe_tpu_torch.ops import conv as p_conv

torch.set_num_threads(2)

PRESETS = [
    "tfhe_parameters_80", "tfhe_parameters_128", "tfhe_parameters_128_fast",
    "tfhe_parameters_128_fast8", "tfhe_parameters_128_pbs",
    "tfhe_parameters_128_radix", "tfhe_parameters_128_radix_reliable",
    "tfhe_parameters_toy",
]


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields(name):
    ref, port = getattr(tt, name)(), getattr(tp, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("n", "N", "k", "extracted_size", "bs_base", "ks_base"):
        assert getattr(port, prop) == getattr(ref, prop)


def test_preset_mask_size_argument():
    for name in ("tfhe_parameters_80", "tfhe_parameters_128"):
        assert dataclasses.asdict(getattr(tp, name)(2)) == \
            dataclasses.asdict(getattr(tt, name)(2))


@pytest.mark.parametrize("ms", [2, 8, 512, 2048])
def test_encode_decode(ms):
    for mu in range(-ms, ms + 1, max(1, ms // 8)):
        assert p_num.encode_message(mu, ms) == j_num.encode_message(mu, ms)
    rng = np.random.default_rng(ms)
    phase = words(rng, (64,))
    phase[:4] = [-(2**31), 2**31 - 1, 0, -1]
    same(p_num.decode_message(torch.from_numpy(phase), ms),
         j_num.decode_message(jnp.asarray(phase), ms))


def test_dtot32():
    rng = np.random.default_rng(1)
    d = (rng.standard_normal(256) * 2.0**-10).astype(np.float32)
    d[:3] = [0.0, -0.25, 0.4999]
    # outside [-0.5, 0.5) the cast saturates, and NaN gives 0
    d[3:8] = [0.5, 0.75, 1.0, -0.75, np.nan]
    same(p_num.dtot32(torch.from_numpy(d)), j_num.dtot32(jnp.asarray(d)))


def test_samplers_cover_the_torus_and_are_seeded():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = p_num.rand_uniform_torus32(g1, (4096,))
    assert torch.equal(a, p_num.rand_uniform_torus32(g2, (4096,)))
    assert a.dtype == torch.int32 and (a < 0).any() and (a > 2**30).any()
    bits = p_num.rand_uniform_bool(g1, (256,))
    assert set(bits.tolist()) == {0, 1}


@pytest.mark.parametrize("shifts", [[-1, -300, -512, 0], [512, 513, 1000, 2 ** 20 + 7]])
def test_mul_by_monomial(shifts):
    """Negative shifts and shifts >= 2N, batched and scalar."""
    rng = np.random.default_rng(2)
    p = words(rng, (4, 3, 256))
    s = np.asarray(shifts, np.int32)
    same(p_poly.mul_by_monomial(torch.from_numpy(p), torch.from_numpy(s)[:, None]),
         j_poly.mul_by_monomial(jnp.asarray(p), jnp.asarray(s)[:, None]))
    same(p_poly.mul_by_monomial(torch.from_numpy(p), shifts[1]),
         j_poly.mul_by_monomial(jnp.asarray(p), shifts[1]))


def test_reverse_polynomial():
    p = words(np.random.default_rng(3), (2, 3, 64))
    same(p_poly.reverse_polynomial(torch.from_numpy(p)),
         j_poly.reverse_polynomial(jnp.asarray(p)))


def test_split_torus_limbs_edges():
    x = words(np.random.default_rng(4), (200,))
    x[:6] = [-(2**31), 2**31 - 1, -1, 0, 128, -128]
    got = p_conv.split_torus_limbs(torch.from_numpy(x))
    same(got, j_conv.split_torus_limbs(jnp.asarray(x)))
    back = sum(got[j].to(torch.int64) << (8 * j) for j in range(4))
    np.testing.assert_array_equal(back.to(torch.int32).numpy(), x)


def test_prepare_shared_torus_and_keygen_product():
    rng = np.random.default_rng(5)
    t = words(rng, (3, 2, 64))
    t[0, 0, :4] = -(2**31)
    same(p_conv.prepare_shared_torus(torch.from_numpy(t)),
         j_conv.prepare_shared_torus(jnp.asarray(t)))
    a = words(rng, (5, 2, 64))
    s = rng.integers(0, 2, (2, 64)).astype(np.int32)
    same(p_conv.poly_mul_batched_torus(torch.from_numpy(a), torch.from_numpy(s)),
         j_conv.poly_mul_batched_torus(jnp.asarray(a), jnp.asarray(s)))


def test_i8_matmul_pads_to_any_shape():
    rng = np.random.default_rng(6)
    a = rng.integers(-128, 128, (3, 13)).astype(np.int8)
    b = rng.integers(-128, 128, (13, 5)).astype(np.int8)
    got = p_conv.i8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int32) @ b.astype(np.int32))


def test_lwe_cores():
    rng = np.random.default_rng(7)
    n, batch = 16, (3, 2)
    a = words(rng, batch + (n,))
    key = rng.integers(0, 2, (n,)).astype(np.int32)
    msg = words(rng, batch)
    noise = rng.integers(-1000, 1000, batch).astype(np.int32)
    ref = j_lwe.lwe_encrypt_core(jnp.asarray(msg), jnp.asarray(a),
                                 jnp.asarray(noise), jnp.asarray(key))
    got = p_lwe.lwe_encrypt_core(torch.from_numpy(msg), torch.from_numpy(a),
                                 torch.from_numpy(noise), torch.from_numpy(key))
    same(got.a, ref.a)
    same(got.b, ref.b)
    same(p_lwe.lwe_phase(got, torch.from_numpy(key)),
         j_lwe.lwe_phase(ref, jnp.asarray(key)))
    triv_p = p_lwe.lwe_noiseless_trivial(-5, n, batch, device="cpu")
    triv_j = j_lwe.lwe_noiseless_trivial(-5, n, batch)
    for fp, fj in zip(triv_p, triv_j):
        same(fp, fj)
    # arithmetic: a - b, 2 * a, -a
    for op in (lambda s: s - s * 3, lambda s: -(s + s)):
        for fp, fj in zip(op(got), op(ref)):
            np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=1e-6)


def test_tlwe_cores():
    rng = np.random.default_rng(8)
    k, n, batch = 2, 64, (3,)
    a_part = words(rng, batch + (k, n))
    noise = rng.integers(-1000, 1000, batch + (n,)).astype(np.int32)
    key = rng.integers(0, 2, (k, n)).astype(np.int32)
    ref = j_tlwe.tlwe_encrypt_zero_core(jnp.asarray(a_part), jnp.asarray(noise),
                                        jnp.asarray(key))
    got = p_tlwe.tlwe_encrypt_zero_core(torch.from_numpy(a_part),
                                        torch.from_numpy(noise),
                                        torch.from_numpy(key))
    same(got.a, ref.a)
    shift = np.asarray([-3, 0, 200], np.int32)
    rp = p_tlwe.tlwe_mul_by_monomial(got, torch.from_numpy(shift))
    rj = j_tlwe.tlwe_mul_by_monomial(ref, jnp.asarray(shift))
    same(rp.a, rj.a)
    ep, ej = p_tlwe.tlwe_extract_sample(rp), j_tlwe.tlwe_extract_sample(rj)
    same(ep.a, ej.a)
    same(ep.b, ej.b)
    same(p_tlwe.extract_lwe_key(torch.from_numpy(key)),
         j_tlwe.extract_lwe_key(jnp.asarray(key)))
    mu = words(rng, (2, n))
    same(p_tlwe.tlwe_noiseless_trivial(torch.from_numpy(mu), k).a,
         j_tlwe.tlwe_noiseless_trivial(jnp.asarray(mu), k).a)


@pytest.mark.parametrize("l,b", [(2, 8), (3, 7), (2, 10), (4, 6), (8, 4)])
def test_gadget_values_and_offset(l, b):
    assert list(p_tgsw.gadget_values(l, b)) == \
        [int(v) for v in j_tgsw.gadget_values(l, b)]
    for balanced in (False, True):
        assert p_tgsw.decomp_offset(l, b, balanced) == \
            j_tgsw.decomp_offset(l, b, balanced)


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("l,b", [(2, 8), (3, 7)])
def test_decompose(l, b, balanced):
    x = words(np.random.default_rng(9), (3, 2, 64))
    x[0, 0, :5] = [-(2**31), 2**31 - 1, 0, -1, 1]
    got = p_tgsw.decompose(torch.from_numpy(x), l, b, balanced)
    same(got, j_tgsw.decompose(jnp.asarray(x), l, b, balanced))
    assert int(got.min()) >= -(1 << (b - 1)) and int(got.max()) < 1 << (b - 1)


def test_tgsw_cores_and_prepare():
    rng = np.random.default_rng(10)
    n_keys, l, b, k, n = 3, 2, 8, 2, 64
    a_parts = words(rng, (n_keys, l, k + 1, k, n))
    noises = rng.integers(-1000, 1000, (n_keys, l, k + 1, n)).astype(np.int32)
    key = rng.integers(0, 2, (k, n)).astype(np.int32)
    msg = rng.integers(0, 2, (n_keys,)).astype(np.int32)
    zj = j_tgsw.tgsw_encrypt_zero_core(jnp.asarray(a_parts), jnp.asarray(noises),
                                       jnp.asarray(key))
    zp = p_tgsw.tgsw_encrypt_zero_core(torch.from_numpy(a_parts),
                                       torch.from_numpy(noises),
                                       torch.from_numpy(key))
    same(zp, zj)
    gj = j_tgsw.tgsw_add_gadget_times_message(zj, jnp.asarray(msg), l, b)
    gp = p_tgsw.tgsw_add_gadget_times_message(zp, torch.from_numpy(msg), l, b)
    same(gp, gj)
    same(p_tgsw.prepare_tgsw(gp, l, b), j_tgsw.prepare_tgsw(gj, l, b))


@pytest.mark.parametrize("balanced", [False, True])
def test_noise_functions(balanced):
    args = [(4, 2, 8, 256, 2.0**-25), (1, 3, 7, 1024, 2.0**-25)]
    for mask, l, b, n, sigma in args:
        assert p_noise.decompose_bias_var(mask, l, b, n) == \
            j_noise.decompose_bias_var(mask, l, b, n)
        assert p_noise.extern_product_var(mask, l, b, n, sigma, balanced) == \
            j_noise.extern_product_var(mask, l, b, n, sigma, balanced)
        assert p_noise.blind_rotate_var(630, mask, l, b, n, sigma, balanced) == \
            j_noise.blind_rotate_var(630, mask, l, b, n, sigma, balanced)
    assert p_noise.keyswitch_var(1024, 8, 2, 2.0**-15) == \
        j_noise.keyswitch_var(1024, 8, 2, 2.0**-15)
