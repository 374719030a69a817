"""The port's compact (prepared-limb) bootstrap key equals the reference's.

Inputs are made with numpy from a seed and go through `tfhe_tpu` and
`tfhe_tpu_torch`; every comparison is array-equal. Where the reference
reaches its Pallas kernel it runs as its own tests run it on the CPU:
`tuning.override(cmux="pallas")` (interpret mode), and also `cmux="xla"`.

* `split_small_limbs`, `poly_mul_prepared`, `tgsw_extern_mul_prepared`;
* `expand_karatsuba_step` against the reference's and against the rows of
  `bake_karatsuba`, M in {1, 2, 4}, depth 0-2;
* `bootstrap_key_from_raw` choosing the reference's form per budget;
* `blind_rotate` through the compact key: toy, the M = 1 geometry, and
  depth 0 with M > 1 (the prepared fallback);
* one NAND gate through a reference compact `CloudKey` carried across by
  `interop`;
* an emulation of the expansion kernel's arithmetic from its table
  (`entry_masks`, as csrc/compact.cu reads it) against the plain version;
* on a CUDA card only: the kernels against their plain versions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import gates as j_gates
from tfhe_tpu import tgsw as j_tgsw
from tfhe_tpu import tlwe as j_tlwe
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.ops import conv as j_conv
from tfhe_tpu.ops import karatsuba as j_kar
from tfhe_tpu.params import SchemeParameters as JParams
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import gates as p_gates
from tfhe_tpu_torch import interop
from tfhe_tpu_torch import tgsw as p_tgsw
from tfhe_tpu_torch import tuning as p_tuning
from tfhe_tpu_torch.ops import compact
from tfhe_tpu_torch.ops import conv as p_conv
from tfhe_tpu_torch.ops import karatsuba as p_kar

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.mark.parametrize("bound_bits", [6, 7, 8, 9, 11])
def test_split_small_limbs(bound_bits):
    rng = np.random.default_rng(bound_bits)
    half = 1 << bound_bits
    d = rng.integers(-half, half, (5, 33)).astype(np.int32)
    d[0, :2] = [-half, half - 1]
    want, want_shifts = j_conv.split_small_limbs(jnp.asarray(d), bound_bits)
    got, got_shifts = p_conv.split_small_limbs(torch.from_numpy(d), bound_bits)
    assert tuple(got_shifts) == tuple(want_shifts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("log2_base,max_bytes", [
    (7, 256 * 2**20), (10, 256 * 2**20), (8, 4096),  # 4096: chunked over P
])
def test_poly_mul_prepared(log2_base, max_bytes):
    rng = np.random.default_rng(log2_base)
    bsz, p, k, n = 3, 4, 2, 32
    key = words(rng, (p, k, n))
    key[0, 0, :2] = -(2**31)
    half = 1 << (log2_base - 1)
    digits = rng.integers(-half, half, (bsz, p, n)).astype(np.int32)
    want = j_conv.poly_mul_prepared(
        jnp.asarray(digits), j_conv.prepare_shared_torus(jnp.asarray(key)),
        log2_base - 1, max_bytes)
    got = p_conv.poly_mul_prepared(
        torch.from_numpy(digits),
        p_conv.prepare_shared_torus(torch.from_numpy(key)),
        log2_base - 1, max_bytes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("l,b,balanced", [(3, 7, False), (2, 8, True),
                                          (2, 10, False)])
def test_tgsw_extern_mul_prepared(l, b, balanced):
    rng = np.random.default_rng(l * b)
    bsz, k1, n = 3, 2, 32
    gsw = words(rng, (l, k1, k1, n))
    acc = words(rng, (bsz, k1, n))
    cv = np.full((bsz,), 1e-7, np.float32)
    want = j_tgsw.tgsw_extern_mul_prepared(
        j_tlwe.TLweSample(jnp.asarray(acc), jnp.asarray(cv)),
        j_tgsw.prepare_tgsw(jnp.asarray(gsw), l, b), l, b, balanced)
    got = p_tgsw.tgsw_extern_mul_prepared(
        interop.tlwe_sample_from_numpy(acc, cv, device="cpu"),
        p_tgsw.prepare_tgsw(torch.from_numpy(gsw), l, b), l, b, balanced)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.cv.numpy(), np.asarray(want.cv))


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_expand_karatsuba_step(m, depth):
    rng = np.random.default_rng(10 * m + depth)
    t, p, k, log2_base = 16, 3, 2, 8
    n = m * t
    key = words(rng, (2, p, k, n))
    key[1, 0, 0, :3] = [-(2**31), 2**31 - 1, -1]
    plan_j = j_kar.karatsuba_plan(m, depth, log2_base)
    plan_p = p_kar.karatsuba_plan(m, depth, log2_base)
    limbs_j = j_conv.prepare_shared_torus(jnp.asarray(key))
    limbs_p = p_conv.prepare_shared_torus(torch.from_numpy(key))
    got = p_kar.expand_karatsuba_step(limbs_p[1], t, plan_p)
    want = j_kar.expand_karatsuba_step(limbs_j[1], t, plan_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    baked = p_kar.bake_karatsuba(limbs_p, t, plan_p)
    assert torch.equal(got, baked[1])
    assert torch.equal(compact.expand_step(limbs_p[1], t=t, plan=plan_p), got)


def emulate_expand(limbs_step, t, plan):
    """The expansion kernel's arithmetic, block by block, from its table."""
    _, p, k1, n2 = limbs_step.shape
    masks = compact.entry_masks(plan)
    assert len(masks) == plan.total_rows
    lim = limbs_step.numpy().astype(np.int64)
    out = np.zeros((plan.total_rows * p * t, k1 * 4 * t), np.int8)
    j = np.arange(2 * t)
    u, w = np.arange(t)[:, None], np.arange(t)[None, :]
    for r, mask in enumerate(masks):
        for pj in range(p):
            for k in range(k1):
                total = np.zeros(2 * t, np.int64)
                for d in range(32):
                    if mask >> d & 1:
                        idx = (d * t - t + j) & (n2 - 1)
                        total += sum(lim[q, pj, k, idx] << (8 * q)
                                     for q in range(4))
                cur = total & 0xFFFFFFFF
                for limb in range(4):
                    lo = ((cur & 255) ^ 128) - 128
                    rows = slice((r * p + pj) * t, (r * p + pj + 1) * t)
                    cols = slice((k * 4 + limb) * t, (k * 4 + limb + 1) * t)
                    out[rows, cols] = lo[t + w - u]
                    cur = ((cur - lo) & 0xFFFFFFFF)
                    cur = ((cur ^ 0x80000000) - 0x80000000) >> 8  # arithmetic
                    cur &= 0xFFFFFFFF
    return out


@pytest.mark.parametrize("m,depth,log2_base", [(1, 0, 8), (2, 1, 8),
                                               (8, 2, 6), (4, 0, 10)])
def test_expansion_table_emulation_matches_plain(m, depth, log2_base):
    rng = np.random.default_rng(m + depth)
    t, p, k1 = 8, 2, 2
    key = words(rng, (p, k1, m * t))
    key[0, 0, :3] = [-(2**31), 2**31 - 1, -1]
    plan = p_kar.karatsuba_plan(m, depth, log2_base)
    limbs = p_conv.prepare_shared_torus(torch.from_numpy(key))
    want = compact.expand_step_plain(limbs, t=t, plan=plan)
    np.testing.assert_array_equal(emulate_expand(limbs, t, plan),
                                  want.numpy())


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("budget", [-1, 0, 1, 1 << 40])
def test_bootstrap_key_form_follows_budget(budget, depth):
    rng = np.random.default_rng(3)
    l, b, t, k1, n = 2, 8, 32, 2, 64
    gsw = words(rng, (3, l, k1, k1, n))
    with j_tuning.override(bs_bake_budget=budget, karatsuba_depth=depth):
        want = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, block=t,
                                           noise_stddev=1e-7, balanced=True)
    with p_tuning.override(bs_bake_budget=budget, karatsuba_depth=depth):
        got = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b,
                                          block=t, noise_stddev=1e-7,
                                          balanced=True)
    assert got.compact == want.compact == (budget in (0, 1))
    assert got.depth == want.depth == depth
    np.testing.assert_array_equal(got.baked.numpy(), np.asarray(want.baked))
    meta = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
            if f.name != "baked"}
    assert meta == {name: getattr(want, name) for name in meta}


COMPACT_CASES = [  # (N, l, b, T, depth, k1, reference engine)
    (256, 3, 7, 128, 1, 2, "pallas"),   # toy geometry
    (256, 3, 7, 128, 1, 2, "xla"),
    (128, 2, 8, 128, 2, 3, "pallas"),   # M = 1: depth clamps to 0
    (128, 2, 8, 128, 2, 3, "xla"),
    (256, 2, 8, 128, 0, 2, "pallas"),   # depth 0, M > 1: prepared fallback
    (256, 2, 8, 128, 0, 2, "xla"),
    (64, 2, 10, 16, 2, 2, "xla"),       # two-limb digits at every leaf
]


@pytest.mark.parametrize("n,l,b,t,depth,k1,cmux", COMPACT_CASES)
def test_compact_blind_rotate_matches_reference(n, l, b, t, depth, k1, cmux):
    rng = np.random.default_rng(n + 7 * depth + b)
    n_lwe, batch = 3, 4
    gsw = words(rng, (n_lwe, l, k1, k1, n))
    acc0 = words(rng, (batch, k1, n))
    bara = rng.integers(0, 2 * n, (batch, n_lwe)).astype(np.int32)
    bara[0, :] = 0
    cv = np.full((batch,), 1e-6, np.float32)
    kw = dict(block=t, depth=depth, noise_stddev=2.0**-25, balanced=(b == 8))
    with j_tuning.override(bs_bake_budget=0):
        bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, **kw)
    with p_tuning.override(bs_bake_budget=0):
        bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, **kw)
    assert bk_p.compact and bk_j.compact and bk_p.depth == bk_j.depth
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

    # and the baked form of the same raw key gives the same words
    bk_b = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, **kw)
    assert not bk_b.compact
    baked = p_bs.blind_rotate(
        interop.tlwe_sample_from_numpy(acc0, cv, device="cpu"), bk_b,
                              torch.from_numpy(bara))
    assert torch.equal(baked.a, got.a)


def m1_params(cls):
    return cls(
        lwe_size=16, lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=128, tlwe_mask_size=2,
        bs_decomp_length=2, bs_log2_base=8, bs_noise_stddev=2.0**-25,
        ks_decomp_length=8, ks_log2_base=2, ks_noise_stddev=2.0**-15,
        max_parties=1, gadget_balanced=True)


@functools.lru_cache(maxsize=None)
def reference_compact_keys(geometry):
    """One reference compact key pair per geometry, its port twin and two
    encrypted inputs, made once for the module (both engines' cases read
    them)."""
    if geometry == "toy":
        params_j, params_p = tt.tfhe_parameters_toy(), tp.tfhe_parameters_toy()
    else:
        params_j, params_p = m1_params(JParams), m1_params(tp.SchemeParameters)
    with j_tuning.override(bs_bake_budget=0):
        sk, ck = tt.make_key_pair(jax.random.PRNGKey(5), params_j)
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
def test_nand_through_reference_compact_cloud_key(cmux, geometry):
    params_p, sk, ck, ck_p, xs, ys, ct_x, ct_y = \
        reference_compact_keys(geometry)
    assert ck.bootstrap_key.compact
    assert ck_p.bootstrap_key.compact
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


def test_port_keygen_compact_round_trip():
    """The port's own keygen under bs_bake_budget=0 at the M = 1 geometry."""
    g = torch.Generator().manual_seed(99)
    with p_tuning.override(bs_bake_budget=0):
        sk, ck = tp.make_key_pair(g, m1_params(tp.SchemeParameters))
    bk = ck.bootstrap_key
    assert bk.compact and bk.depth == 0 and bk.block == 128
    assert tuple(bk.baked.shape) == (16, 4, 6, 3, 256)
    xs = torch.tensor([0, 0, 1, 1], dtype=torch.bool)
    ys = torch.tensor([0, 1, 0, 1], dtype=torch.bool)
    out = tp.gate_nand(ck, tp.encrypt(g, sk, xs), tp.encrypt(g, sk, ys))
    assert torch.equal(tp.decrypt(sk, out), ~(xs & ys))


def test_compact_kernels_refuse_cpu_tensors():
    plan = p_kar.karatsuba_plan(2, 1, 8)
    limbs = torch.zeros((1, 4, 4, 2, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        compact.expand_step_kernel(limbs[0], t=128, plan=plan)
    with pytest.raises(ValueError, match="CUDA"):
        compact.blind_rotate_compact_kernel(
            torch.zeros((2, 2, 256), dtype=torch.int32), limbs,
            torch.zeros((1, 2), dtype=torch.int32), l=2, b=8, t=128,
            plan=plan, balanced=True)


@pytest.mark.cuda
def test_compact_kernels_match_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(12)
    for k1, n, l, b, depth, n_lwe, batch in [(9, 128, 2, 8, 0, 3, 300),
                                             (5, 256, 2, 8, 1, 3, 70),
                                             (2, 1024, 2, 10, 2, 2, 17)]:
        gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n))).to(dev)
        with p_tuning.override(bs_bake_budget=0, karatsuba_depth=depth):
            bk = p_bs.bootstrap_key_from_raw(gsw, l, b, balanced=(b == 8))
        assert bk.compact
        acc = torch.from_numpy(words(rng, (batch, k1, n))).to(dev)
        bara_t = torch.from_numpy(
            rng.integers(-n, n, (n_lwe, batch)).astype(np.int32)).to(dev)
        kw = dict(t=bk.block, plan=bk.plan)
        assert torch.equal(compact.expand_step_kernel(bk.baked[1], **kw),
                           compact.expand_step_plain(bk.baked[1], **kw))
        kw.update(l=l, b=b, balanced=bk.balanced)
        got = compact.blind_rotate_compact_kernel(acc, bk.baked, bara_t, **kw)
        want = compact.blind_rotate_compact_plain(acc, bk.baked, bara_t, **kw)
        assert torch.equal(got, want)
