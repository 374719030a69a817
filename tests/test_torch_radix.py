"""The port's radix integers equal the reference's.

Keys and ciphertexts are made by `tfhe_tpu` from a seed (4-bit words, toy
parameters) and carried over with `tfhe_tpu_torch.interop`. Ciphertext words
are compared array-equal, no tolerance (`cv` with `allclose`), for
`radix_add` under `radix_manylut` on and off, `radix_sub`, `radix_geq`,
`radix_select`, `radix_xor` and an odd `radix_shift_left`. Every other
public function is checked at decrypt level against plain integer
arithmetic, through the port's own keygen and encryption; `radix_divide` at
2 digits only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import radix as j_radix
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu_torch import interop
from tfhe_tpu_torch import radix as p_radix
from tfhe_tpu_torch import tuning as p_tuning

torch.set_num_threads(2)

BITS = 4
MOD = 1 << BITS


def fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def to_port(sample):
    return interop.lwe_sample_from_numpy(*(np.asarray(x) for x in sample),
                                         device="cpu")


def same_sample(port, ref):
    np.testing.assert_array_equal(port.a.numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(port.b.numpy(), np.asarray(ref.b))
    np.testing.assert_allclose(port.cv.numpy(), np.asarray(ref.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def shared():
    """Reference keys and two encrypted word batches, and the same in the
    port's types."""
    params = tt.tfhe_parameters_toy()
    sk, ck = tt.make_key_pair(jax.random.PRNGKey(21), params)
    ck_p = interop.cloud_key_from_numpy(
        tp.tfhe_parameters_toy(), fields(ck.bootstrap_key),
        fields(ck.keyswitch_key), device="cpu")
    sk_p = interop.secret_key_from_numpy(tp.tfhe_parameters_toy(),
                                         np.asarray(sk.key), device="cpu")
    av = np.asarray([5, 9, 15], np.uint32)
    bv = np.asarray([3, 9, 1], np.uint32)
    ca = j_radix.encrypt_radix(jax.random.PRNGKey(1), sk, jnp.asarray(av), BITS)
    cb = j_radix.encrypt_radix(jax.random.PRNGKey(2), sk, jnp.asarray(bv), BITS)
    return dict(sk=sk, ck=ck, sk_p=sk_p, ck_p=ck_p, av=av, bv=bv, ca=ca,
                cb=cb, ca_p=to_port(ca), cb_p=to_port(cb))


def test_digit_packing_matches_reference():
    values = np.asarray([0, 1, 0xDEADBEEF, 0xFFFFFFFF, 77], np.uint32)
    got = p_radix.int_to_digits(values, 16, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_radix.int_to_digits(jnp.asarray(values), 16)))
    back = p_radix.digits_to_int(got)
    assert back.dtype == torch.int64
    np.testing.assert_array_equal(back.numpy(), values.astype(np.int64))
    # negative inputs are their two's complement word
    np.testing.assert_array_equal(
        p_radix.int_to_digits(torch.tensor([-1, -3]), 2).numpy(),
        [[3, 3], [1, 3]])


def test_decrypt_of_reference_ciphertexts(shared):
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], shared["ca_p"]).numpy(),
        shared["av"])


@pytest.mark.parametrize("manylut", [True, False])
def test_radix_add_matches_reference(shared, manylut):
    with j_tuning.override(radix_manylut=manylut):
        want = j_radix.radix_add(shared["ck"], shared["ca"], shared["cb"])
    with p_tuning.override(radix_manylut=manylut):
        got = p_radix.radix_add(shared["ck_p"], shared["ca_p"],
                                shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], got).numpy(),
        (shared["av"] + shared["bv"]) % MOD)


def test_manylut_changes_the_words_not_the_integers(shared):
    outs = []
    for manylut in (True, False):
        with p_tuning.override(radix_manylut=manylut):
            outs.append(p_radix.radix_add(shared["ck_p"], shared["ca_p"],
                                          shared["cb_p"]))
    assert not torch.equal(outs[0].a, outs[1].a)
    assert torch.equal(p_radix.decrypt_radix(shared["sk_p"], outs[0]),
                       p_radix.decrypt_radix(shared["sk_p"], outs[1]))


def test_radix_sub_and_geq_match_reference(shared):
    want = j_radix.radix_sub(shared["ck"], shared["ca"], shared["cb"])
    got = p_radix.radix_sub(shared["ck_p"], shared["ca_p"], shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], got).numpy(),
        (shared["av"].astype(np.int64) - shared["bv"]) % MOD)
    want = j_radix.radix_geq(shared["ck"], shared["ca"], shared["cb"])
    got = p_radix.radix_geq(shared["ck_p"], shared["ca_p"], shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_pbs(shared["sk_p"], got, p_radix.SPACE).numpy(),
        shared["av"] >= shared["bv"])


def test_radix_select_matches_reference(shared):
    flag_j = j_radix._scaled_flag(
        shared["ck"], j_radix.radix_geq(shared["ck"], shared["ca"],
                                        shared["cb"]))
    want = j_radix.radix_select(shared["ck"], flag_j, shared["ca"],
                                shared["cb"])
    flag_p = p_radix._scaled_flag(
        shared["ck_p"], p_radix.radix_geq(shared["ck_p"], shared["ca_p"],
                                          shared["cb_p"]))
    same_sample(flag_p, flag_j)
    got = p_radix.radix_select(shared["ck_p"], flag_p, shared["ca_p"],
                               shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], got).numpy(),
        np.maximum(shared["av"], shared["bv"]))


def test_radix_xor_matches_reference(shared):
    want = j_radix.radix_xor(shared["ck"], shared["ca"], shared["cb"])
    got = p_radix.radix_xor(shared["ck_p"], shared["ca_p"], shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], got).numpy(),
        shared["av"] ^ shared["bv"])


def test_odd_shift_left_matches_reference(shared):
    want = j_radix.radix_shift_left(shared["ck"], shared["ca"], 1)
    got = p_radix.radix_shift_left(shared["ck_p"], shared["ca_p"], 1)
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_radix.decrypt_radix(shared["sk_p"], got).numpy(),
        (shared["av"] << 1) % MOD)


# --- decrypt level, the port's own keys ---


@pytest.fixture(scope="module")
def own():
    g = torch.Generator().manual_seed(404)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    av = torch.tensor([5, 9, 15, 0, 12, 7])
    bv = torch.tensor([3, 9, 1, 6, 13, 7])
    return dict(g=g, sk=sk, ck=ck, av=av, bv=bv,
                ca=p_radix.encrypt_radix(g, sk, av, BITS),
                cb=p_radix.encrypt_radix(g, sk, bv, BITS))


def signed(v):
    return torch.where(v >= MOD // 2, v - MOD, v)


UNSIGNED_OPS = {
    "radix_add": (lambda ck, a, b: p_radix.radix_add(ck, a, b),
                  lambda a, b: (a + b) % MOD),
    "radix_scalar_add": (lambda ck, a, b: p_radix.radix_scalar_add(ck, a, 11),
                         lambda a, b: (a + 11) % MOD),
    "radix_sub": (lambda ck, a, b: p_radix.radix_sub(ck, a, b),
                  lambda a, b: (a - b) % MOD),
    "radix_min": (lambda ck, a, b: p_radix.radix_min(ck, a, b), torch.minimum),
    "radix_max": (lambda ck, a, b: p_radix.radix_max(ck, a, b), torch.maximum),
    "radix_mul": (lambda ck, a, b: p_radix.radix_mul(ck, a, b),
                  lambda a, b: (a * b) % MOD),
    "radix_and": (lambda ck, a, b: p_radix.radix_and(ck, a, b),
                  lambda a, b: a & b),
    "radix_or": (lambda ck, a, b: p_radix.radix_or(ck, a, b),
                 lambda a, b: a | b),
    "radix_xor": (lambda ck, a, b: p_radix.radix_xor(ck, a, b),
                  lambda a, b: a ^ b),
    "radix_not": (lambda ck, a, b: p_radix.radix_not(a),
                  lambda a, b: (MOD - 1) - a),
    "radix_shift_left_2": (lambda ck, a, b: p_radix.radix_shift_left(ck, a, 2),
                           lambda a, b: (a << 2) % MOD),
    "radix_shift_left_3": (lambda ck, a, b: p_radix.radix_shift_left(ck, a, 3),
                           lambda a, b: (a << 3) % MOD),
    "radix_shift_left_4": (lambda ck, a, b: p_radix.radix_shift_left(ck, a, 4),
                           lambda a, b: a * 0),
    "radix_shift_right_1": (
        lambda ck, a, b: p_radix.radix_shift_right(ck, a, 1),
        lambda a, b: a >> 1),
    "radix_shift_right_2": (
        lambda ck, a, b: p_radix.radix_shift_right(ck, a, 2),
        lambda a, b: a >> 2),
    "radix_neg": (lambda ck, a, b: p_radix.radix_neg(ck, a),
                  lambda a, b: (-a) % MOD),
    "radix_min_signed": (
        lambda ck, a, b: p_radix.radix_min_signed(ck, a, b),
        lambda a, b: torch.minimum(signed(a), signed(b)) % MOD),
    "radix_max_signed": (
        lambda ck, a, b: p_radix.radix_max_signed(ck, a, b),
        lambda a, b: torch.maximum(signed(a), signed(b)) % MOD),
    "radix_abs": (lambda ck, a, b: p_radix.radix_abs(ck, a),
                  lambda a, b: signed(a).abs() % MOD),
    "radix_shift_right_arith_1": (
        lambda ck, a, b: p_radix.radix_shift_right_arith(ck, a, 1),
        lambda a, b: (signed(a) >> 1) % MOD),
    "radix_shift_right_arith_2": (
        lambda ck, a, b: p_radix.radix_shift_right_arith(ck, a, 2),
        lambda a, b: (signed(a) >> 2) % MOD),
    "radix_shift_right_arith_5": (
        lambda ck, a, b: p_radix.radix_shift_right_arith(ck, a, 5),
        lambda a, b: (signed(a) >> 5) % MOD),
}


@pytest.mark.parametrize("name", sorted(UNSIGNED_OPS))
def test_word_functions_decrypt_correctly(own, name):
    fn, truth = UNSIGNED_OPS[name]
    out = fn(own["ck"], own["ca"], own["cb"])
    assert out.b.shape == (6, BITS // 2)
    assert out.a.dtype == torch.int32
    got = p_radix.decrypt_radix(own["sk"], out)
    assert torch.equal(got, truth(own["av"], own["bv"])), name


FLAG_OPS = {
    "radix_geq": (p_radix.radix_geq, lambda a, b: a >= b),
    "radix_eq": (p_radix.radix_eq, lambda a, b: a == b),
    "radix_geq_signed": (p_radix.radix_geq_signed,
                         lambda a, b: signed(a) >= signed(b)),
}


@pytest.mark.parametrize("name", sorted(FLAG_OPS))
def test_flag_functions_decrypt_correctly(own, name):
    fn, truth = FLAG_OPS[name]
    out = fn(own["ck"], own["ca"], own["cb"])
    assert out.b.shape == (6,)
    got = p_radix.decrypt_pbs(own["sk"], out, p_radix.SPACE)
    assert torch.equal(got, truth(own["av"], own["bv"]).to(torch.int32)), name


def test_signed_round_trip(own):
    values = torch.tensor([-8, -1, 0, 3, 7])
    ct = p_radix.encrypt_radix_signed(own["g"], own["sk"], values, BITS)
    got = p_radix.decrypt_radix_signed(own["sk"], ct)
    assert got.dtype == torch.int32
    assert torch.equal(got, values.to(torch.int32))
    assert torch.equal(p_radix.decrypt_radix(own["sk"], ct), values % MOD)


def test_radix_divide_two_digits(own):
    num = torch.tensor([13, 7, 15, 4])
    den = torch.tensor([3, 7, 1, 5])
    cn = p_radix.encrypt_radix(own["g"], own["sk"], num, BITS)
    cd = p_radix.encrypt_radix(own["g"], own["sk"], den, BITS)
    quo, rem = p_radix.radix_divide(own["ck"], cn, cd)
    assert torch.equal(p_radix.decrypt_radix(own["sk"], quo), num // den)
    assert torch.equal(p_radix.decrypt_radix(own["sk"], rem), num % den)


def test_words_with_two_batch_dims(own):
    """A [2, 3] batch of words through the add chain and a stacked-table
    op: the digit axis stays last."""
    av, bv = own["av"].reshape(2, 3), own["bv"].reshape(2, 3)
    ca = p_radix.encrypt_radix(own["g"], own["sk"], av, BITS)
    cb = p_radix.encrypt_radix(own["g"], own["sk"], bv, BITS)
    out = p_radix.radix_add(own["ck"], ca, cb)
    assert out.b.shape == (2, 3, BITS // 2)
    assert torch.equal(p_radix.decrypt_radix(own["sk"], out), (av + bv) % MOD)
    out = p_radix.radix_mul(own["ck"], ca, cb)
    assert torch.equal(p_radix.decrypt_radix(own["sk"], out), (av * bv) % MOD)
