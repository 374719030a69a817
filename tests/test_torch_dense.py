"""The port's dense depth-0 bootstrap key and CMUX step equal the
reference's.

Inputs are made with numpy from a seed and go through `tfhe_tpu` and
`tfhe_tpu_torch`; every comparison is array-equal. The reference's Pallas
step `cmux_step_pallas` runs in interpret mode on the CPU
(`tuning.override(cmux="pallas")`), beside its XLA path (`cmux="xla"`).

* `bake_block_toeplitz` bytes, `block_toeplitz_matmul`,
  `recombine_block_prods`;
* `mux_rotate_baked` and the step's two halves (`rotate_decompose_plain`,
  `cmux_matmul_plain`) against `cmux_step_pallas`;
* `blind_rotate` through the depth-0 key: toy, M = 1, and a b = 10 shape
  with two digit limbs;
* one NAND gate through a reference depth-0 `CloudKey` carried across by
  `interop`;
* an emulation of the dots kernel driven by the dense product table
  (`dense_product_tables`, one target each, as ops/dots.py encodes it)
  against the plain version;
* on a CUDA card only: the kernels against their plain versions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blind_rotate import emulate_dots

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import gates as j_gates
from tfhe_tpu import tlwe as j_tlwe
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.ops import conv as j_conv
from tfhe_tpu.ops.pallas_cmux import cmux_step_pallas
from tfhe_tpu.params import SchemeParameters as JParams
from tfhe_tpu.tgsw import decomp_offset as j_decomp_offset
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import gates as p_gates
from tfhe_tpu_torch import interop
from tfhe_tpu_torch import tuning as p_tuning
from tfhe_tpu_torch.ops import cmux_step, dots
from tfhe_tpu_torch.ops import conv as p_conv

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.mark.parametrize("n,t,steps,chunk", [
    (64, 32, 3, 2), (32, 32, 2, 16), (256, 64, 5, 2), (256, 128, 1, 16),
])
def test_bake_block_toeplitz_bytes(n, t, steps, chunk):
    rng = np.random.default_rng(n + t)
    p, k = 3, 2
    key = words(rng, (steps, p, k, n))
    key[0, 0, 0, :3] = [-(2**31), 2**31 - 1, -1]
    want = j_conv.bake_block_toeplitz(
        j_conv.prepare_shared_torus(jnp.asarray(key)), t)
    got = p_conv.bake_block_toeplitz(
        p_conv.prepare_shared_torus(torch.from_numpy(key)), t, chunk=chunk)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,t,log2_base", [
    (64, 32, 8), (32, 32, 7), (128, 32, 10), (64, 16, 9),
])
def test_block_toeplitz_matmul_and_recombine(n, t, log2_base):
    rng = np.random.default_rng(n + log2_base)
    bsz, p, k = 3, 4, 2
    key = words(rng, (1, p, k, n))
    half = 1 << (log2_base - 1)
    digits = rng.integers(-half, half, (bsz, p, n)).astype(np.int32)
    digits[0, 0, :2] = [-half, half - 1]
    e_j = j_conv.bake_block_toeplitz(
        j_conv.prepare_shared_torus(jnp.asarray(key)), t)[0]
    e_p = p_conv.bake_block_toeplitz(
        p_conv.prepare_shared_torus(torch.from_numpy(key)), t)[0]
    dl_j, sh_j = j_conv.split_small_limbs(jnp.asarray(digits), log2_base - 1)
    dl_p, sh_p = p_conv.split_small_limbs(torch.from_numpy(digits),
                                          log2_base - 1)
    prods_j = j_conv.block_toeplitz_matmul(dl_j, e_j, t)
    prods_p = p_conv.block_toeplitz_matmul(dl_p, e_p, t)
    np.testing.assert_array_equal(prods_p.numpy(), np.asarray(prods_j))
    want = j_conv.recombine_block_prods(prods_j, k, sh_j)
    got = p_conv.recombine_block_prods(prods_p, k, sh_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the product is the prepared (gather at call time) product
    prepared = p_conv.poly_mul_prepared(
        torch.from_numpy(digits),
        p_conv.prepare_shared_torus(torch.from_numpy(key))[0], log2_base - 1)
    assert torch.equal(got, prepared)


STEP_CASES = [  # (N, l, b, T, k1)
    (256, 2, 8, 128, 3),    # M = 2, one digit limb, balanced gadget
    (128, 2, 8, 128, 3),    # M = 1
    (256, 2, 10, 128, 2),   # two digit limbs (nibble split)
    (256, 3, 7, 64, 2),     # T below the kernel's block: plain only
]


@pytest.mark.parametrize("n,l,b,t,k1", STEP_CASES)
def test_dense_step_matches_reference(n, l, b, t, k1):
    rng = np.random.default_rng(n + b + t)
    batch = 4
    balanced = b == 8
    gsw = words(rng, (1, l, k1, k1, n))
    acc = words(rng, (batch, k1, n))
    bara = rng.integers(-n, 2 * n, (batch,)).astype(np.int32)
    bara[0] = 0
    bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, block=t,
                                       depth=0, balanced=balanced)
    bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, block=t,
                                       depth=0, balanced=balanced)
    np.testing.assert_array_equal(bk_p.baked.numpy(), np.asarray(bk_j.baked))

    want = j_bs.mux_rotate_baked(jnp.asarray(acc), bk_j.baked[0],
                                 jnp.asarray(bara), l, b, t, balanced)
    s_limbs = 1 if b <= 8 else 2
    want_k = cmux_step_pallas(
        jnp.asarray(acc), bk_j.baked[0], jnp.asarray(bara), n=n, k1=k1, l=l,
        b=b, t=t, s_limbs=s_limbs, d_shifts=cmux_step.digit_limb_shifts(b),
        offset=j_decomp_offset(l, b, balanced), interpret=True)
    np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want))

    acc_p, bara_p = torch.from_numpy(acc), torch.from_numpy(bara)
    got = p_bs.mux_rotate_baked(acc_p, bk_p.baked[0], bara_p, l, b, t,
                                balanced)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(l=l, b=b, t=t, balanced=balanced)
    halves = cmux_step.cmux_step(acc_p, bk_p.baked[0], bara_p, **kw)
    assert torch.equal(halves, got)
    digits = cmux_step.rotate_decompose_plain(bara_p, acc_p, **kw)
    assert digits.dtype == torch.int8
    assert tuple(digits.shape) == (s_limbs, batch, k1 * l * n)
    assert not digits[:, 0].any()  # bara == 0: all-zero digits


def emulate_dense_kernel(digits, acc, e_step, *, l, b, t):
    """The dots kernel's arithmetic driven by the dense product table, on
    the digit buffer as the CUDA kernel lays it out ([B, S*M segments])."""
    bsz, k1, n = acc.shape
    m, pt = n // t, k1 * l * t
    products = cmux_step.dense_product_tables(
        m, cmux_step.digit_limb_shifts(b))
    assert len({pr[:4] for pr in products}) == len(products)
    for lseg, eseg, nseg, shift, targets in products:
        assert targets == ((m - 1 - eseg, 1),) and eseg + nseg <= 2 * m
    tables = dots.encode_single_key(products, k1, m, pt)
    lhs = digits.permute(1, 0, 2).reshape(bsz, -1)
    out = emulate_dots(acc.to(torch.int64), lhs, e_step, tables, t=t,
                       poly_columns=True)
    return (((out + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


@pytest.mark.parametrize("n,l,b,k1", [(256, 2, 8, 5), (128, 2, 8, 3),
                                      (512, 2, 10, 2)])
def test_dense_table_emulation_matches_plain(n, l, b, k1):
    rng = np.random.default_rng(n * k1)
    t, batch = 128, 3
    gsw = torch.from_numpy(words(rng, (1, l, k1, k1, n)))
    bk = p_bs.bootstrap_key_from_raw(gsw, l, b, block=t, depth=0)
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara = torch.from_numpy(rng.integers(-n, n, (batch,)).astype(np.int32))
    kw = dict(l=l, b=b, t=t)
    digits = cmux_step.rotate_decompose_plain(bara, acc, balanced=(b == 8),
                                              **kw)
    want = cmux_step.cmux_matmul_plain(digits, acc, bk.baked[0], **kw)
    got = emulate_dense_kernel(digits, acc, bk.baked[0], **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.equal(want, p_bs.mux_rotate_baked(
        acc, bk.baked[0], bara, l, b, t, b == 8))


DENSE_CASES = [  # (N, l, b, T, k1, reference engine)
    (256, 3, 7, 128, 2, "pallas"),   # toy geometry at depth 0
    (256, 3, 7, 128, 2, "xla"),
    (128, 2, 8, 128, 3, "pallas"),   # M = 1
    (128, 2, 8, 128, 3, "xla"),
    (256, 2, 10, 128, 2, "pallas"),  # two digit limbs
    (256, 2, 10, 128, 2, "xla"),
]


@pytest.mark.parametrize("n,l,b,t,k1,cmux", DENSE_CASES)
def test_dense_blind_rotate_matches_reference(n, l, b, t, k1, cmux):
    rng = np.random.default_rng(n + b)
    n_lwe, batch = 3, 4
    gsw = words(rng, (n_lwe, l, k1, k1, n))
    acc0 = words(rng, (batch, k1, n))
    bara = rng.integers(0, 2 * n, (batch, n_lwe)).astype(np.int32)
    bara[0, :] = 0
    cv = np.full((batch,), 1e-6, np.float32)
    kw = dict(block=t, noise_stddev=2.0**-25, balanced=(b == 8))
    with j_tuning.override(karatsuba_depth=0):
        bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, **kw)
    with p_tuning.override(karatsuba_depth=0):
        bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, **kw)
    assert bk_p.depth == bk_j.depth == 0 and not bk_p.compact
    np.testing.assert_array_equal(bk_p.baked.numpy(), np.asarray(bk_j.baked))
    with j_tuning.override(cmux=cmux):
        want = j_bs.blind_rotate(
            j_tlwe.TLweSample(jnp.asarray(acc0), jnp.asarray(cv)), bk_j,
            jnp.asarray(bara))
    got = p_bs.blind_rotate(
        interop.tlwe_sample_from_numpy(acc0, cv, device="cpu"), bk_p,
                            torch.from_numpy(bara))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    assert np.array_equal(got.a.numpy()[0], acc0[0])  # bara == 0: unchanged


def m1_params(cls):
    return cls(
        lwe_size=16, lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=128, tlwe_mask_size=2,
        bs_decomp_length=2, bs_log2_base=8, bs_noise_stddev=2.0**-25,
        ks_decomp_length=8, ks_log2_base=2, ks_noise_stddev=2.0**-15,
        max_parties=1, gadget_balanced=True)


@functools.lru_cache(maxsize=None)
def reference_depth0_keys(geometry):
    """One reference depth-0 key pair per geometry, its port twin and two
    encrypted inputs, made once for the module (both engines' cases read
    them)."""
    if geometry == "toy":
        params_j, params_p = tt.tfhe_parameters_toy(), tp.tfhe_parameters_toy()
    else:
        params_j, params_p = m1_params(JParams), m1_params(tp.SchemeParameters)
    with j_tuning.override(karatsuba_depth=0):
        sk, ck = tt.make_key_pair(jax.random.PRNGKey(6), params_j)
    ck_p = interop.cloud_key_from_numpy(
        params_p, fields(ck.bootstrap_key), fields(ck.keyswitch_key),
        device="cpu")
    xs = jnp.asarray([False, False, True, True])
    ys = jnp.asarray([False, True, False, True])
    ct_x = tt.encrypt(jax.random.PRNGKey(1), sk, xs)
    ct_y = tt.encrypt(jax.random.PRNGKey(2), sk, ys)
    return params_p, sk, ck, ck_p, xs, ys, ct_x, ct_y


@pytest.mark.parametrize("geometry", ["toy", "m1"])
@pytest.mark.parametrize("cmux", ["pallas", "xla"])
def test_nand_through_reference_depth0_cloud_key(cmux, geometry):
    params_p, sk, ck, ck_p, xs, ys, ct_x, ct_y = \
        reference_depth0_keys(geometry)
    assert ck.bootstrap_key.depth == 0 and not ck.bootstrap_key.compact
    with j_tuning.override(cmux=cmux):
        want = j_gates.gate_nand(ck, ct_x, ct_y)
    got = p_gates.gate_nand(
        ck_p,
        interop.lwe_sample_from_numpy(*(np.asarray(v) for v in ct_x),
                                      device="cpu"),
        interop.lwe_sample_from_numpy(*(np.asarray(v) for v in ct_y),
                                      device="cpu"))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    sk_p = interop.secret_key_from_numpy(params_p, np.asarray(sk.key),
                                         device="cpu")
    np.testing.assert_array_equal(tp.decrypt(sk_p, got).numpy(),
                                  ~(np.asarray(xs) & np.asarray(ys)))


def test_port_keygen_depth0_round_trip():
    """The port's own keygen under karatsuba_depth=0 at toy parameters."""
    g = torch.Generator().manual_seed(77)
    with p_tuning.override(karatsuba_depth=0):
        sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    bk = ck.bootstrap_key
    assert bk.depth == 0 and not bk.compact
    assert tuple(bk.baked.shape) == (16, 4 * 6 * 128, 2 * 4 * 128)
    xs = torch.tensor([0, 0, 1, 1], dtype=torch.bool)
    ys = torch.tensor([0, 1, 0, 1], dtype=torch.bool)
    out = tp.gate_nand(ck, tp.encrypt(g, sk, xs), tp.encrypt(g, sk, ys))
    assert torch.equal(tp.decrypt(sk, out), ~(xs & ys))


def test_dense_kernels_refuse_cpu_tensors():
    acc = torch.zeros((2, 2, 256), dtype=torch.int32)
    bara = torch.zeros((2,), dtype=torch.int32)
    kw = dict(l=2, b=8, t=128)
    with pytest.raises(ValueError, match="CUDA"):
        cmux_step.rotate_decompose_kernel(bara, acc, balanced=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cmux_step.cmux_matmul_kernel(
            torch.zeros((1, 2, 1024), dtype=torch.int8), acc,
            torch.zeros((2048, 1024), dtype=torch.int8), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cmux_step.blind_rotate_dense_kernel(
            acc, torch.zeros((1, 2048, 1024), dtype=torch.int8),
            bara[None], balanced=True, **kw)


@pytest.mark.cuda
def test_dense_kernels_match_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(13)
    for k1, n, l, b, n_lwe, batch in [(5, 256, 2, 8, 3, 300),
                                      (9, 128, 2, 8, 3, 70),
                                      (2, 1024, 2, 10, 2, 17)]:
        gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n))).to(dev)
        bk = p_bs.bootstrap_key_from_raw(gsw, l, b, depth=0,
                                         balanced=(b == 8))
        acc = torch.from_numpy(words(rng, (batch, k1, n))).to(dev)
        bara_t = torch.from_numpy(
            rng.integers(-n, n, (n_lwe, batch)).astype(np.int32)).to(dev)
        kw = dict(l=l, b=b, t=bk.block, balanced=bk.balanced)
        digits = cmux_step.rotate_decompose_kernel(bara_t[0], acc, **kw)
        assert torch.equal(digits, cmux_step.rotate_decompose_plain(
            bara_t[0], acc, **kw))
        assert bk.layout == "kmajor"
        got = cmux_step.blind_rotate_dense_kernel(acc, bk.baked, bara_t, **kw)
        ref = dots.from_kmajor(bk.baked)
        want = cmux_step.blind_rotate_dense_plain(acc, ref, bara_t, **kw)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="reference layout"):
            cmux_step.blind_rotate_dense_kernel(acc, ref, bara_t, **kw)
