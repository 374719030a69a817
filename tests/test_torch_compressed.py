"""Seeded artifacts and modulus-switched results, in both directions.

A seeded artifact made by `tfhe_tpu.compressed` loads in the port and
expands to the same words as the reference's expansion, and one made by
`tfhe_tpu_torch.compressed` loads in the reference and expands there to
the port's words: the masks go through the threefry twin. The port's
seeded bootstrap key keeps the reference's row phases, its seeded cloud
key and 2-party ceremony run gates, and `compress_lwe`/`decompress_lwe`
give the reference's words at 8, 16 and 32 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import compressed as jc
from tfhe_tpu import mk as j_mk
from tfhe_tpu.utils import serialization as js
from tfhe_tpu_torch import compressed as pc
from tfhe_tpu_torch import mk as p_mk
from tfhe_tpu_torch.ops import conv as p_conv
from tfhe_tpu_torch.utils import serialization as ps

torch.set_num_threads(2)


def to_port(obj):
    return ps.loads(js.dumps(obj), device="cpu")


def to_ref(obj):
    return js.loads(ps.dumps(obj))


def equal(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def keys():
    """The toy secret key in both packages, a seeded cloud key made by each,
    and each one's expansion by the package that made it."""
    sk_j = tt.make_secret_key(jax.random.PRNGKey(11), tt.tfhe_parameters_toy())
    sk_p = to_port(sk_j)
    ref = jc.make_seeded_cloud_key(jax.random.PRNGKey(12), sk_j)
    port = pc.make_seeded_cloud_key(torch.Generator().manual_seed(12), sk_p)
    return dict(sk_j=sk_j, sk_p=sk_p, ref=ref, port=port,
                ref_x=jc.expand_cloud_key(ref), port_x=pc.expand_cloud_key(port))


def test_seeded_lwe_both_ways(keys):
    bits = [True, False, True, True, False]
    ref = jc.encrypt_seeded(jax.random.PRNGKey(42), keys["sk_j"],
                            jnp.asarray(bits))
    got = pc.expand_lwe(to_port(ref))
    want = jc.expand_lwe(ref)
    equal(got.a, want.a)
    equal(got.b, want.b)
    port = pc.encrypt_seeded(torch.Generator().manual_seed(3), keys["sk_p"],
                             bits)
    back = jc.expand_lwe(to_ref(port))
    equal(pc.expand_lwe(port).a, back.a)
    np.testing.assert_array_equal(np.asarray(tt.decrypt(keys["sk_j"], back)),
                                  bits)
    assert port.batch_shape == (5,) and port.seed.dtype == torch.uint32


@pytest.mark.parametrize("maker", ["ref", "port"])
def test_seeded_cloud_key_expands_alike(keys, maker):
    """Bootstrap and keyswitch keys: the other package's expansion of the
    artifact's bytes gives the maker's words."""
    if maker == "ref":
        seeded_p = to_port(keys["ref"])
        got = pc.expand_cloud_key(seeded_p)
        want = keys["ref_x"]
    else:
        seeded_p = keys["port"]
        got = keys["port_x"]
        want = jc.expand_cloud_key(to_ref(seeded_p))
    equal(got.bootstrap_key.baked, want.bootstrap_key.baked)
    equal(got.keyswitch_key.table_limbs, want.keyswitch_key.table_limbs)
    assert (got.bootstrap_key.depth, got.bootstrap_key.block) \
        == (want.bootstrap_key.depth, want.bootstrap_key.block)
    assert got.keyswitch_key.noise_stddev == want.keyswitch_key.noise_stddev
    assert seeded_p.bootstrap_key.seed.dtype == torch.uint32


def test_seeded_bootstrap_key_row_phases(keys):
    """As tests/test_compressed.py:71 for the reference: each expanded TGSW
    row's phase is noise plus its message, -m*g_i*s_j on mask rows and
    +m*g_i on the body's constant term."""
    params = keys["sk_p"].params
    g = torch.Generator().manual_seed(9)
    tlwe_key = tp.tlwe_key_gen(g, params.tlwe_polynomial_degree,
                               params.tlwe_mask_size)
    l, b = params.bs_decomp_length, params.bs_log2_base
    seeded = pc.bootstrap_key_gen_seeded(g, params.bs_noise_stddev,
                                         keys["sk_p"].key, tlwe_key, l, b)
    n_poly, k = params.tlwe_polynomial_degree, params.tlwe_mask_size
    a_part = tp.threefry.uniform_torus32(
        seeded.seed, (keys["sk_p"].key.shape[0], l, k + 1, k, n_poly))
    mask_dot = p_conv.poly_mul_batched_torus(
        a_part.reshape(-1, k, n_poly), tlwe_key).reshape(a_part.shape[0], l,
                                                         k + 1, n_poly)
    phases = (seeded.body - mask_dot).numpy()
    gv = np.asarray(tt.gadget_values(l, b))
    m = keys["sk_p"].key.numpy()
    want = np.zeros(phases.shape, np.int32)
    for j in range(k):
        want[:, :, j, :] = (-(m[:, None, None] * gv[None, :, None])
                            * tlwe_key.numpy()[j]).astype(np.int32)
    want[:, :, k, 0] = (m[:, None] * gv[None, :]).astype(np.int32)
    err = (phases.astype(np.int64) - want).astype(np.int32)
    bound = int(params.bs_noise_stddev * 2**32 * 8) + 1
    assert np.abs(err.astype(np.int64)).max() < bound


def test_seeded_cloud_key_gates(keys):
    """NAND truth table through the port's expansion of its own seeded
    key."""
    g = torch.Generator().manual_seed(13)
    x = torch.tensor([False, False, True, True])
    y = torch.tensor([False, True, False, True])
    sk = keys["sk_p"]
    out = tp.gate_nand(keys["port_x"], tp.encrypt(g, sk, x),
                       tp.encrypt(g, sk, y))
    assert torch.equal(tp.decrypt(sk, out), ~(x & y))


def test_seeded_mk_ceremony_both_ways():
    """The 2-party seeded ceremony: the reference's artifacts expand in the
    port to the reference's words; the port's expand in the reference to
    the port's; the port's parts assemble into a key whose NAND is right."""
    params_j = j_mk.mktfhe_parameters_toy(2)
    r_shared, r0, r1 = jax.random.split(jax.random.PRNGKey(42), 3)
    shared_s = jc.make_shared_key_seeded(r_shared, params_j)
    shared_j = jc.expand_shared_key(shared_s)
    shared_p = pc.expand_shared_key(to_port(shared_s))
    equal(shared_p.a, shared_j.a)
    r_sk, r_part = jax.random.split(r0)
    sk_j = tt.make_secret_key(r_sk, params_j)
    part_s = jc.make_seeded_cloud_key_part(r_part, sk_j, shared_j)
    want = jc.expand_cloud_key_part(part_s)
    got = pc.expand_cloud_key_part(to_port(part_s))
    equal(got.key_uni_enc.cd, want.key_uni_enc.cd)
    equal(got.public_key, want.public_key)
    equal(got.keyswitch_key.table_limbs, want.keyswitch_key.table_limbs)

    g = torch.Generator().manual_seed(5)
    params_p = p_mk.mktfhe_parameters_toy(2)
    seeded = pc.make_shared_key_seeded(g, params_p)
    shared = pc.expand_shared_key(seeded)
    equal(shared.a, jc.expand_shared_key(to_ref(seeded)).a)
    sks, parts = [], []
    for _ in range(2):
        sks.append(tp.make_secret_key(g, params_p))
        part_s = pc.make_seeded_cloud_key_part(g, sks[-1], shared)
        parts.append(pc.expand_cloud_key_part(part_s))
        back = jc.expand_cloud_key_part(to_ref(part_s))
        equal(parts[-1].key_uni_enc.cd, back.key_uni_enc.cd)
        equal(parts[-1].keyswitch_key.table_limbs,
              back.keyswitch_key.table_limbs)
        assert len(ps.dumps(part_s)) * 2 < len(ps.dumps(parts[-1]))
    ck = p_mk.make_mk_cloud_key(parts)
    xs = torch.tensor([False, True, True])
    ys = torch.tensor([True, True, False])
    out = p_mk.mk_gate_nand(ck, p_mk.mk_encrypt(g, sks, xs),
                            p_mk.mk_encrypt(g, sks, ys))
    assert torch.equal(p_mk.mk_decrypt(sks, out), ~(xs & ys))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_compress_lwe_matches_reference(keys, bits):
    ct = tt.encrypt(jax.random.PRNGKey(90), keys["sk_j"],
                    jnp.asarray([True, False] * 8))
    want = jc.compress_lwe(ct, bits)
    got = pc.compress_lwe(to_port(ct), bits)
    equal(got.a, want.a)
    equal(got.b, want.b)
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv),
                               rtol=1e-6)
    back = pc.decompress_lwe(to_port(want))
    ref_back = jc.decompress_lwe(want)
    equal(back.a, ref_back.a)
    equal(back.b, ref_back.b)
    np.testing.assert_array_equal(
        tp.decrypt(keys["sk_p"], back).numpy(), [True, False] * 8)
    with pytest.raises(ValueError):
        pc.compress_lwe(got if bits == 32 else to_port(ct), 1)
