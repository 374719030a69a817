"""The port's programmable bootstrapping equals the reference's.

Keys and ciphertexts are made by `tfhe_tpu` from a seed and carried over
with `tfhe_tpu_torch.interop`, so both sides see the same words; every
comparison of ciphertext words is array-equal (no tolerance; `cv` is float32
and compared with `allclose`).

* the encoding round trip, and `decode_pbs` on negative phases;
* `lut_test_polynomial` and `lut_many_test_polynomial` against the
  reference for q in {2, 4}, with and without leading table dims, and the
  layout v[m*w + r] = enc(T_{r % q}[m]) written out;
* `programmable_bootstrap` and `programmable_bootstrap_many` against the
  reference, with a shared table and with per-sample tables;
* a chained f(f(m)) through the port's own keygen and encryption;
* multi-key PBS and many-LUT at `mktfhe_parameters_toy(2)`: equal words to
  the reference (its toy run takes seconds, so no decrypt-level shortcut is
  needed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import pbs as j_pbs
from tfhe_tpu.mk import api as j_mk
from tfhe_tpu_torch import interop
from tfhe_tpu_torch import pbs as p_pbs
from tfhe_tpu_torch.mk import api as p_mk

torch.set_num_threads(2)


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
def keys():
    params = tt.tfhe_parameters_toy()
    sk, ck = tt.make_key_pair(jax.random.PRNGKey(11), params)
    ck_p = interop.cloud_key_from_numpy(
        tp.tfhe_parameters_toy(), fields(ck.bootstrap_key),
        fields(ck.keyswitch_key), device="cpu")
    sk_p = interop.secret_key_from_numpy(tp.tfhe_parameters_toy(),
                                         np.asarray(sk.key), device="cpu")
    return sk, ck, sk_p, ck_p


@pytest.mark.parametrize("space", [2, 4, 8])
def test_encoding_round_trip(space):
    msgs = np.arange(2 * space)
    enc = p_pbs.encode_pbs(msgs, space, device="cpu")
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(j_pbs.encode_pbs(jnp.asarray(msgs), space)))
    np.testing.assert_array_equal(p_pbs.decode_pbs(enc, space).numpy(), msgs)
    # a phase just below zero decodes to 0, one further down to 2S - 1
    # (floor remainder of a negative rounded value)
    step = 1 << (32 - (space.bit_length() - 1) - 1)
    phases = np.asarray([-1, -step // 2 - 1, -step], np.int32)
    np.testing.assert_array_equal(
        p_pbs.decode_pbs(torch.from_numpy(phases), space).numpy(),
        np.asarray(j_pbs.decode_pbs(jnp.asarray(phases), space)))
    assert p_pbs.decode_pbs(torch.from_numpy(phases), space).tolist() == \
        [0, 2 * space - 1, 2 * space - 1]


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_lut_test_polynomial_matches_reference(lead):
    rng = np.random.default_rng(5)
    space, n = 8, 256
    table = rng.integers(0, space, lead + (space,))
    got = p_pbs.lut_test_polynomial(table, space, n, device="cpu")
    want = j_pbs.lut_test_polynomial(jnp.asarray(table), space, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # repeat_interleave: window m holds entry m
    assert got.shape == lead + (n,)
    assert got[..., 33].tolist() == p_pbs.encode_pbs(
        table[..., 1], space, device="cpu").tolist()


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_lut_many_test_polynomial_matches_reference(q, lead):
    rng = np.random.default_rng(q)
    space, n = 8, 256
    w = n // space
    tables = rng.integers(0, space, lead + (q, space))
    got = p_pbs.lut_many_test_polynomial(tables, space, q, n,
                                         device="cpu")
    want = j_pbs.lut_many_test_polynomial(jnp.asarray(tables), space, q, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    enc = p_pbs.encode_pbs(tables, space, device="cpu").numpy()
    for m in range(space):
        for r in range(w):
            np.testing.assert_array_equal(got[..., m * w + r].numpy(),
                                          enc[..., r % q, m])


def test_programmable_bootstrap_matches_reference(keys):
    sk, ck, sk_p, ck_p = keys
    space = 4
    msgs = np.arange(8) % space
    table = [2, 0, 3, 1]
    ct = j_pbs.encrypt_pbs(jax.random.PRNGKey(3), sk, jnp.asarray(msgs), space)
    want = j_pbs.programmable_bootstrap(
        ck.bootstrap_key, ck.keyswitch_key, jnp.asarray(table), ct, space)
    got = p_pbs.programmable_bootstrap(
        ck_p.bootstrap_key, ck_p.keyswitch_key, table, to_port(ct), space)
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_pbs.decrypt_pbs(sk_p, got, space).numpy(), np.asarray(table)[msgs])
    # the extracted (k*N)-dim sample before the keyswitch
    want_u = j_pbs.programmable_bootstrap_wo_keyswitch(
        ck.bootstrap_key, jnp.asarray(table), ct, space)
    got_u = p_pbs.programmable_bootstrap_wo_keyswitch(
        ck_p.bootstrap_key, torch.tensor(table), to_port(ct), space)
    same_sample(got_u, want_u)


def test_programmable_bootstrap_per_sample_tables(keys):
    sk, ck, sk_p, ck_p = keys
    space = 8
    rng = np.random.default_rng(9)
    msgs = rng.integers(0, space, (3, 2))
    tables = rng.integers(0, space, (2, space))  # broadcast over the 3
    ct = j_pbs.encrypt_pbs(jax.random.PRNGKey(4), sk, jnp.asarray(msgs), space)
    want = j_pbs.programmable_bootstrap(
        ck.bootstrap_key, ck.keyswitch_key, jnp.asarray(tables), ct, space)
    got = p_pbs.programmable_bootstrap(
        ck_p.bootstrap_key, ck_p.keyswitch_key, tables, to_port(ct), space)
    same_sample(got, want)
    assert got.b.shape == (3, 2)
    np.testing.assert_array_equal(
        p_pbs.decrypt_pbs(sk_p, got, space).numpy(),
        np.stack([tables[0][msgs[:, 0]], tables[1][msgs[:, 1]]], axis=-1))


@pytest.mark.parametrize("q,space", [(2, 8), (4, 4)])
def test_programmable_bootstrap_many_matches_reference(keys, q, space):
    sk, ck, sk_p, ck_p = keys
    rng = np.random.default_rng(q + space)
    msgs = rng.integers(0, space, (5,))
    tables = rng.integers(0, space, (q, space))
    ct = j_pbs.encrypt_pbs(jax.random.PRNGKey(6), sk, jnp.asarray(msgs), space)
    want = j_pbs.programmable_bootstrap_many(
        ck.bootstrap_key, ck.keyswitch_key, jnp.asarray(tables), ct, space, q)
    got = p_pbs.programmable_bootstrap_many(
        ck_p.bootstrap_key, ck_p.keyswitch_key, tables, to_port(ct), space, q)
    same_sample(got, want)
    assert got.b.shape == (5, q)
    np.testing.assert_array_equal(
        p_pbs.decrypt_pbs(sk_p, got, space).numpy(), tables[:, msgs].T)


def test_programmable_bootstrap_many_per_sample_tables(keys):
    sk, ck, sk_p, ck_p = keys
    space, q = 8, 2
    rng = np.random.default_rng(21)
    msgs = rng.integers(0, space, (2, 3))
    tables = rng.integers(0, space, (3, q, space))  # one pair per column
    ct = j_pbs.encrypt_pbs(jax.random.PRNGKey(8), sk, jnp.asarray(msgs), space)
    want = j_pbs.programmable_bootstrap_many(
        ck.bootstrap_key, ck.keyswitch_key, jnp.asarray(tables), ct, space, q)
    got = p_pbs.programmable_bootstrap_many(
        ck_p.bootstrap_key, ck_p.keyswitch_key, tables, to_port(ct), space, q)
    same_sample(got, want)
    assert got.b.shape == (2, 3, q)


def test_chained_lut_with_the_ports_own_keys():
    g = torch.Generator().manual_seed(77)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    space = 4
    msgs = torch.arange(16) % space
    lut = torch.tensor([2, 0, 3, 1])
    ct = p_pbs.encrypt_pbs(g, sk, msgs, space)
    assert torch.equal(p_pbs.decrypt_pbs(sk, ct, space), msgs.to(torch.int32))
    once = p_pbs.programmable_bootstrap(ck.bootstrap_key, ck.keyswitch_key,
                                        lut, ct, space)
    twice = p_pbs.programmable_bootstrap(ck.bootstrap_key, ck.keyswitch_key,
                                         lut, once, space)
    assert torch.equal(p_pbs.decrypt_pbs(sk, twice, space),
                       lut[lut[msgs]].to(torch.int32))


# --- multi-key ---


@pytest.fixture(scope="module")
def mk_keys():
    params = j_mk.mktfhe_parameters_toy(2)
    params_p = p_mk.mktfhe_parameters_toy(2)
    rng = jax.random.PRNGKey(31)
    r_shared, r_sk, r_parts = jax.random.split(rng, 3)
    shared = j_mk.make_shared_key(r_shared, params)
    sks = [tt.make_secret_key(k, params) for k in jax.random.split(r_sk, 2)]
    parts = [j_mk.make_cloud_key_part(k, sk, shared)
             for k, sk in zip(jax.random.split(r_parts, 2), sks)]
    ck = j_mk.make_mk_cloud_key(parts)
    bk = fields(ck.bootstrap_key)
    assert not ck.bootstrap_key.sparse
    ck_p = interop.mk_cloud_key_from_numpy(
        params_p, bk, [fields(k) for k in ck.keyswitch_keys], device="cpu")
    sks_p = [interop.secret_key_from_numpy(params_p, np.asarray(sk.key),
                                           device="cpu")
             for sk in sks]
    return sks, ck, sks_p, ck_p


def mk_to_port(sample):
    return interop.mk_lwe_sample_from_numpy(
        *(np.asarray(x) for x in sample), device="cpu")


def test_mk_encrypt_decrypt_pbs_round_trip(mk_keys):
    sks, ck, sks_p, ck_p = mk_keys
    space = 4
    msgs = np.arange(6) % space
    ct = j_pbs.mk_encrypt_pbs(jax.random.PRNGKey(2), sks, jnp.asarray(msgs),
                              space)
    np.testing.assert_array_equal(
        p_pbs.mk_decrypt_pbs(sks_p, mk_to_port(ct), space).numpy(),
        np.asarray(j_pbs.mk_decrypt_pbs(sks, ct, space)))
    g = torch.Generator().manual_seed(5)
    own = p_pbs.mk_encrypt_pbs(g, sks_p, torch.from_numpy(msgs), space)
    assert own.a.shape == (6, 2, sks_p[0].params.lwe_size)
    np.testing.assert_array_equal(
        p_pbs.mk_decrypt_pbs(sks_p, own, space).numpy(), msgs)


def test_mk_programmable_bootstrap_matches_reference(mk_keys):
    sks, ck, sks_p, ck_p = mk_keys
    space = 4
    msgs = np.arange(4) % space
    table = [2, 0, 3, 1]
    ct = j_pbs.mk_encrypt_pbs(jax.random.PRNGKey(12), sks, jnp.asarray(msgs),
                              space)
    want = j_pbs.mk_programmable_bootstrap(
        ck.bootstrap_key, ck.keyswitch_keys, jnp.asarray(table), ct, space)
    got = p_pbs.mk_programmable_bootstrap(
        ck_p.bootstrap_key, ck_p.keyswitch_keys, table, mk_to_port(ct), space)
    same_sample(got, want)
    np.testing.assert_array_equal(
        p_pbs.mk_decrypt_pbs(sks_p, got, space).numpy(),
        np.asarray(table)[msgs])


def test_mk_programmable_bootstrap_many_matches_reference(mk_keys):
    sks, ck, sks_p, ck_p = mk_keys
    space, q = 4, 2
    msgs = np.arange(4) % space
    tables = np.asarray([[2, 0, 3, 1], [1, 3, 0, 2]])
    ct = j_pbs.mk_encrypt_pbs(jax.random.PRNGKey(13), sks, jnp.asarray(msgs),
                              space)
    want = j_pbs.mk_programmable_bootstrap_many(
        ck.bootstrap_key, ck.keyswitch_keys, jnp.asarray(tables), ct, space, q)
    got = p_pbs.mk_programmable_bootstrap_many(
        ck_p.bootstrap_key, ck_p.keyswitch_keys, tables, mk_to_port(ct),
        space, q)
    same_sample(got, want)
    assert got.b.shape == (4, q) and got.a.shape[:2] == (4, q)
    np.testing.assert_array_equal(
        p_pbs.mk_decrypt_pbs(sks_p, got, space).numpy(), tables[:, msgs].T)


@pytest.mark.parametrize("helper", ["encode_pbs", "lut_test_polynomial",
                                    "lut_many_test_polynomial",
                                    "int_to_digits", "int_to_bits"])
def test_helpers_place_inputs_like_the_entry_points(helper, monkeypatch):
    """device=None: a CPU tensor stays on the CPU, a list goes to the card
    (the device `torch.as_tensor` is asked for, recorded here so that the
    test needs no card)."""
    from tfhe_tpu_torch import circuits as p_circ
    from tfhe_tpu_torch import radix as p_radix

    calls = {
        "encode_pbs": lambda v: p_pbs.encode_pbs(v, 4),
        "lut_test_polynomial": lambda v: p_pbs.lut_test_polynomial(v, 4, 16),
        "lut_many_test_polynomial":
            lambda v: p_pbs.lut_many_test_polynomial([v, v], 4, 2, 16),
        "int_to_digits": lambda v: p_radix.int_to_digits(v, 3),
        "int_to_bits": lambda v: p_circ.int_to_bits(v, 5),
    }
    call = calls[helper]
    values = [0, 1, 2, 3]
    asked = []
    as_tensor = torch.as_tensor

    def spy(data, *args, device=None, **kw):
        asked.append(str(device))
        return as_tensor(data, *args, **kw)  # built on the CPU all the same

    if helper == "lut_many_test_polynomial":  # a tensor input stays a tensor
        cpu_in = torch.tensor([values, values])
        kept = p_pbs.lut_many_test_polynomial(cpu_in, 4, 2, 16)
    else:
        kept = call(torch.tensor(values))
    assert kept.device.type == "cpu"
    monkeypatch.setattr(torch, "as_tensor", spy)
    call(values)
    assert asked and set(asked) == {"cuda"}, asked
    asked.clear()
    calls["encode_pbs"](torch.tensor(values))
    assert set(asked) == {"cpu"}, asked
