"""The port's bit circuits equal the reference's.

Keys and ciphertexts are made by `tfhe_tpu` from a seed (4-bit words, toy
parameters) and carried over with `tfhe_tpu_torch.interop`:
`ripple_carry_add` and `encrypted_greater_than` return the same words as the
reference (array-equal, no tolerance; `cv` with `allclose`). The other
circuits are checked at decrypt level against plain integer arithmetic
through the port's own keys. Also here: `gate_constant` with the
reference's signature (a scalar with a batch shape, an array) gives the
reference's words.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import circuits as j_circ
from tfhe_tpu import gates as j_gates
from tfhe_tpu_torch import circuits as p_circ
from tfhe_tpu_torch import gates as p_gates
from tfhe_tpu_torch import interop

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
    params = tt.tfhe_parameters_toy()
    sk, ck = tt.make_key_pair(jax.random.PRNGKey(33), params)
    ck_p = interop.cloud_key_from_numpy(
        tp.tfhe_parameters_toy(), fields(ck.bootstrap_key),
        fields(ck.keyswitch_key), device="cpu")
    sk_p = interop.secret_key_from_numpy(tp.tfhe_parameters_toy(),
                                         np.asarray(sk.key), device="cpu")
    av = np.asarray([5, 9, 15], np.uint32)
    bv = np.asarray([3, 9, 1], np.uint32)
    ca = j_circ.encrypt_word(jax.random.PRNGKey(1), sk, jnp.asarray(av), BITS)
    cb = j_circ.encrypt_word(jax.random.PRNGKey(2), sk, jnp.asarray(bv), BITS)
    return dict(sk=sk, ck=ck, sk_p=sk_p, ck_p=ck_p, av=av, bv=bv, ca=ca,
                cb=cb, ca_p=to_port(ca), cb_p=to_port(cb))


@pytest.mark.parametrize("value,batch_shape", [
    (True, (3,)), (False, (2, 3)), (True, ()),
    (np.asarray([True, False, True]), (3,)),
    (np.asarray([[True], [False]]), (2, 4)),
])
def test_gate_constant_matches_reference(shared, value, batch_shape):
    want = j_gates.gate_constant(shared["ck"], value, batch_shape)
    got = p_gates.gate_constant(shared["ck_p"], value, batch_shape)
    same_sample(got, want)
    assert got.a.shape == tuple(batch_shape) + (shared["ck_p"].params.lwe_size,)
    assert got.b.device == shared["ck_p"].keyswitch_key.table_limbs.device
    # a tensor works like an array, and no batch shape means the value's
    as_tensor = p_gates.gate_constant(
        shared["ck_p"], torch.as_tensor(np.asarray(value)), batch_shape)
    assert torch.equal(as_tensor.b, got.b)
    if np.ndim(value):
        own_shape = p_gates.gate_constant(shared["ck_p"], value)
        assert own_shape.b.shape == np.shape(value)


def test_bits_round_trip_matches_reference():
    values = np.asarray([0, 1, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    bits = p_circ.int_to_bits(values, 32, device="cpu")
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(j_circ.int_to_bits(jnp.asarray(values), 32)))
    np.testing.assert_array_equal(p_circ.bits_to_int(bits).numpy(),
                                  values.astype(np.int64))


def test_decrypt_word_of_reference_ciphertexts(shared):
    np.testing.assert_array_equal(
        p_circ.decrypt_word(shared["sk_p"], shared["ca_p"]).numpy(),
        shared["av"])


def test_ripple_carry_add_matches_reference(shared):
    want = j_circ.ripple_carry_add(shared["ck"], shared["ca"], shared["cb"])
    got = p_circ.ripple_carry_add(shared["ck_p"], shared["ca_p"],
                                  shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_circ.decrypt_word(shared["sk_p"], got).numpy(),
        (shared["av"] + shared["bv"]) % MOD)


def test_encrypted_greater_than_matches_reference(shared):
    want = j_circ.encrypted_greater_than(shared["ck"], shared["ca"],
                                         shared["cb"])
    got = p_circ.encrypted_greater_than(shared["ck_p"], shared["ca_p"],
                                        shared["cb_p"])
    same_sample(got, want)
    np.testing.assert_array_equal(
        tp.decrypt(shared["sk_p"], got).numpy(), shared["av"] > shared["bv"])


# --- decrypt level, the port's own keys ---


@pytest.fixture(scope="module")
def own():
    g = torch.Generator().manual_seed(505)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    av = torch.tensor([5, 9, 15, 0, 12, 7])
    bv = torch.tensor([3, 9, 1, 6, 13, 7])
    return dict(g=g, sk=sk, ck=ck, av=av, bv=bv,
                ca=p_circ.encrypt_word(g, sk, av, BITS),
                cb=p_circ.encrypt_word(g, sk, bv, BITS))


WORD_OPS = {
    "encrypted_minimum": (p_circ.encrypted_minimum, torch.minimum),
    "encrypted_maximum": (p_circ.encrypted_maximum, torch.maximum),
    "ripple_carry_add": (p_circ.ripple_carry_add, lambda a, b: (a + b) % MOD),
    "ripple_carry_sub": (p_circ.ripple_carry_sub, lambda a, b: (a - b) % MOD),
    "multiply": (p_circ.multiply, lambda a, b: (a * b) % MOD),
}


@pytest.mark.parametrize("name", sorted(WORD_OPS))
def test_word_circuits_decrypt_correctly(own, name):
    fn, truth = WORD_OPS[name]
    out = fn(own["ck"], own["ca"], own["cb"])
    assert out.b.shape == (6, BITS)
    assert torch.equal(p_circ.decrypt_word(own["sk"], out),
                       truth(own["av"], own["bv"])), name


BIT_OPS = {
    "encrypted_greater_than": (p_circ.encrypted_greater_than,
                               lambda a, b: a > b),
    "encrypted_equal": (p_circ.encrypted_equal, lambda a, b: a == b),
}


@pytest.mark.parametrize("name", sorted(BIT_OPS))
def test_bit_circuits_decrypt_correctly(own, name):
    fn, truth = BIT_OPS[name]
    out = fn(own["ck"], own["ca"], own["cb"])
    assert out.b.shape == (6,)
    assert torch.equal(tp.decrypt(own["sk"], out),
                       truth(own["av"], own["bv"])), name


def test_sub_with_borrow_and_compare_bit(own):
    diff, no_borrow = p_circ._sub_with_borrow(own["ck"], own["ca"], own["cb"])
    assert torch.equal(p_circ.decrypt_word(own["sk"], diff),
                       (own["av"] - own["bv"]) % MOD)
    assert torch.equal(tp.decrypt(own["sk"], no_borrow),
                       own["av"] >= own["bv"])
    a0, b0 = p_circ._bit(own["ca"], 0), p_circ._bit(own["cb"], 0)
    carry = tp.gate_constant(own["ck"], True, (6,))
    out = p_circ.compare_bit(own["ck"], a0, b0, carry)
    bit_a, bit_b = own["av"] & 1, own["bv"] & 1
    assert torch.equal(tp.decrypt(own["sk"], out),
                       torch.where(bit_a == bit_b, True, bit_a != 0))


def test_divide(own):
    num = torch.tensor([13, 7, 15, 4])
    den = torch.tensor([3, 7, 1, 5])
    cn = p_circ.encrypt_word(own["g"], own["sk"], num, BITS)
    cd = p_circ.encrypt_word(own["g"], own["sk"], den, BITS)
    quo, rem = p_circ.divide(own["ck"], cn, cd)
    assert torch.equal(p_circ.decrypt_word(own["sk"], quo), num // den)
    assert torch.equal(p_circ.decrypt_word(own["sk"], rem), num % den)


def test_broadcast_bit_is_a_view_and_gates_take_it(own):
    bit = p_circ._bit(own["cb"], 1)
    wide = p_circ._broadcast_bit(bit, BITS)
    assert wide.a.shape == own["ca"].a.shape
    assert wide.a.data_ptr() == bit.a.data_ptr()  # zero-copy
    out = tp.gate_and(own["ck"], own["ca"], wide)
    want = torch.where((own["bv"] >> 1) & 1 != 0, own["av"], 0)
    assert torch.equal(p_circ.decrypt_word(own["sk"], out), want)
