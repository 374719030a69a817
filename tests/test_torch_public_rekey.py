"""Public-key encryption and re-keying against `tfhe_tpu`.

* `encrypt_public` gives the reference's words for the same key and the
  same selector (the reference's own Bernoulli draw, handed to the port's
  injected-selector core), and the limb-split subset-sum equals the int32
  product it replaces;
* the seeded public key crosses packages both ways;
* public-key and re-keyed ciphertexts feed gates;
* `rekey` gives the reference's words for the same re-keying key and
  ciphertexts; `default_count` is the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import public as j_pub
from tfhe_tpu import rekey as j_rekey
from tfhe_tpu.utils import serialization as js
from tfhe_tpu_torch import public as p_pub
from tfhe_tpu_torch import rekey as p_rekey
from tfhe_tpu_torch.utils import serialization as ps

torch.set_num_threads(2)


def to_port(obj):
    return ps.loads(js.dumps(obj), device="cpu")


def equal(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def keys():
    """Two users' toy keys from the reference, one cloud key made by the
    port for the first, both in both packages."""
    params = tt.tfhe_parameters_toy()
    sk_j = tt.make_secret_key(jax.random.PRNGKey(1), params)
    sk2_j = tt.make_secret_key(jax.random.PRNGKey(2), params)
    sk_p, sk2_p = to_port(sk_j), to_port(sk2_j)
    g = torch.Generator().manual_seed(3)
    return dict(sk_j=sk_j, sk2_j=sk2_j, sk_p=sk_p, sk2_p=sk2_p, g=g,
                ck_p=tp.make_cloud_key(g, sk_p),
                ck2_p=tp.make_cloud_key(g, sk2_p))


def test_default_count():
    for name in ("tfhe_parameters_toy", "tfhe_parameters_128_fast",
                 "tfhe_parameters_80"):
        for security in (128, 80):
            assert p_pub.default_count(getattr(tp, name)(), security) \
                == j_pub.default_count(getattr(tt, name)(), security)


def test_subset_sums_equal_the_int32_product():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (9, 700)).astype(np.int32)
    w = rng.integers(-(2**31), 2**31, (700, 17), dtype=np.int64) \
        .astype(np.int32)
    w[:3] = -(2**31)  # the limb split's edge
    u[0] = 1
    got = p_pub._subset_sums(torch.from_numpy(u), torch.from_numpy(w))
    want = torch.from_numpy(u) @ torch.from_numpy(w)  # int32 wraps on CPU
    assert torch.equal(got, want)


def test_encrypt_public_matches_reference(keys):
    count = 300
    pk_j = j_pub.make_public_key(jax.random.PRNGKey(7), keys["sk_j"], count)
    pk_p = to_port(pk_j)
    assert pk_p.count == count
    bits = jnp.asarray([True, False, False, True, True])
    rng = jax.random.PRNGKey(8)
    want = j_pub.encrypt_public(rng, pk_j, bits)
    u = jax.random.bernoulli(rng, 0.5, bits.shape + (count,))
    got = p_pub._encrypt_public_core(
        torch.from_numpy(np.asarray(u).astype(np.int32)), pk_p,
        torch.from_numpy(np.array(bits)))
    equal(got.a, want.a)
    equal(got.b, want.b)
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv),
                               rtol=1e-6)


def test_seeded_public_key_both_ways(keys):
    seeded_j = j_pub.make_public_key_seeded(jax.random.PRNGKey(9),
                                            keys["sk_j"], 64)
    got = p_pub.expand_public_key(to_port(seeded_j))
    want = j_pub.expand_public_key(seeded_j)
    equal(got.zeros.a, want.zeros.a)
    equal(got.zeros.b, want.zeros.b)
    seeded_p = p_pub.make_public_key_seeded(keys["g"], keys["sk_p"], 512)
    back = j_pub.expand_public_key(js.loads(ps.dumps(seeded_p)))
    equal(p_pub.expand_public_key(seeded_p).zeros.a, back.zeros.a)
    assert len(ps.dumps(seeded_p)) * 3 < len(
        ps.dumps(p_pub.expand_public_key(seeded_p)))


def test_public_and_rekeyed_ciphertexts_feed_gates(keys):
    g, sk, sk2 = keys["g"], keys["sk_p"], keys["sk2_p"]
    pk = p_pub.expand_public_key(p_pub.make_public_key_seeded(g, sk))
    x = torch.tensor([False, False, True, True])
    y = torch.tensor([False, True, False, True])
    cx = p_pub.encrypt_public(g, pk, x)
    cy = p_pub.encrypt_public(g, p_pub.make_public_key(g, sk, 400), y)
    assert torch.equal(tp.decrypt(sk, cx), x)
    out = tp.gate_nand(keys["ck_p"], cx, cy)
    assert torch.equal(tp.decrypt(sk, out), ~(x & y))
    rk = p_rekey.make_rekey_key(g, sk, sk2)
    moved = p_rekey.rekey(rk, out)
    assert torch.equal(tp.decrypt(sk2, moved), ~(x & y))
    out2 = tp.gate_and(keys["ck2_p"], moved, p_rekey.rekey(rk, cx))
    assert torch.equal(tp.decrypt(sk2, out2), ~(x & y) & x)


def test_rekey_matches_reference(keys):
    rk_j = j_rekey.make_rekey_key(jax.random.PRNGKey(10), keys["sk_j"],
                                  keys["sk2_j"])
    ct = tt.encrypt(jax.random.PRNGKey(11), keys["sk_j"],
                    jnp.asarray([True, False, True]))
    want = j_rekey.rekey(rk_j, ct)
    got = p_rekey.rekey(to_port(rk_j), to_port(ct))
    equal(got.a, want.a)
    equal(got.b, want.b)
    seeded = p_rekey.make_rekey_key_seeded(keys["g"], keys["sk_p"],
                                           keys["sk2_p"])
    moved = p_rekey.rekey(tp.compressed.expand_keyswitch_key(seeded),
                          to_port(ct))
    assert torch.equal(tp.decrypt(keys["sk2_p"], moved),
                       torch.tensor([True, False, True]))
    other = tp.make_secret_key(keys["g"], tp.tfhe_parameters_80())
    with pytest.raises(ValueError, match="matching parameters"):
        p_rekey.make_rekey_key(keys["g"], keys["sk_p"], other)
