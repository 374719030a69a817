"""The port's multi-key TFHE (`tfhe_tpu_torch.mk`) equals the reference's.

Inputs are made with numpy from a seed and go through `tfhe_tpu.mk` and
`tfhe_tpu_torch.mk`; int32 words are compared array-equal, `cv` as float32
to 1e-6 relative. Torch and JAX draw different random numbers, so equality
goes through the injected-randomness cores and through ceremonies made by
`tfhe_tpu` and carried across by `interop`.

* the presets, field by field; the noise formulas;
* `public_key_core`, `mk_tgsw_encrypt_core`, `mk_tgsw_expand`,
  `build_extern_operand(_sparse)`, `mk_keyswitch`, the sample arithmetic;
* `mk_bootstrap_key` choosing the reference's form per knob;
* the slice: 2- and 4-party toy ceremonies, `mk_gate_nand` and
  `mk_gate_mux` in both packages; every path of the port (baked, prepared,
  expansion from dense and sparse-stored keys, chunk, compact, triangular
  rotation on and off) equal to each other; the compact path at M = 4,
  depth 2 against the reference's prepared path;
* the port's own ceremony: the 12 gates' truth tables, distributed
  decryption.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu.mk as j_mk
import tfhe_tpu_torch as tp
from tfhe_tpu import keyswitch as j_ks
from tfhe_tpu import noise as j_noise
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.mk import internals as j_mki
from tfhe_tpu.params import SchemeParameters as JParams
from tfhe_tpu_torch import interop
from tfhe_tpu_torch import keyswitch as p_ks
from tfhe_tpu_torch import mk as p_mk
from tfhe_tpu_torch import noise as p_noise
from tfhe_tpu_torch import tuning as p_tuning
from tfhe_tpu_torch.mk import internals as p_mki

torch.set_num_threads(2)

N, L, B = 64, 3, 7


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def bits(rng, shape):
    return rng.integers(0, 2, shape).astype(np.int32)


def tt_(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def bk_fields(bk):
    out = {f.name: getattr(bk, f.name) for f in dataclasses.fields(bk)}
    out["limbs"] = ([np.asarray(x) for x in bk.limbs] if bk.sparse
                    else np.asarray(bk.limbs))
    return out


def assert_samples_equal(got, want):
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


PRESETS = ["mktfhe_parameters_2party", "mktfhe_parameters_2party_lownoise",
           "mktfhe_parameters_4party", "mktfhe_parameters_8party",
           "mktfhe_parameters_toy"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_reference(name):
    args = [(), (4,)] if name.endswith("toy") else [()]
    for a in args:
        want = dataclasses.asdict(getattr(j_mk, name)(*a))
        got = dataclasses.asdict(getattr(p_mk, name)(*a))
        assert got == want


@pytest.mark.parametrize("parties,l,b,balanced", [(2, 4, 7, False),
                                                  (2, 5, 6, True),
                                                  (4, 5, 6, False),
                                                  (8, 8, 4, False)])
def test_mk_noise_formulas(parties, l, b, balanced):
    args = (parties, l, b, 1024, 3.29e-10)
    assert p_noise.mk_expand_var(*args) == j_noise.mk_expand_var(*args)
    assert p_noise.mk_extern_product_var(*args, balanced) == \
        j_noise.mk_extern_product_var(*args, balanced)
    assert p_noise.mk_blind_rotate_var(parties, 500, l, b, 1024, 3.29e-10,
                                       balanced) == \
        j_noise.mk_blind_rotate_var(parties, 500, l, b, 1024, 3.29e-10,
                                    balanced)


def test_public_key_core():
    rng = np.random.default_rng(1)
    key, shared, noise = bits(rng, (1, N)), words(rng, (L, N)), \
        words(rng, (L, N))
    want = j_mki.public_key_core(key, shared, noise)
    got = p_mki.public_key_core(tt_(key), tt_(shared), tt_(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def random_ue(rng, batch=()):
    return dict(
        message=bits(rng, batch) if batch else 1, r=bits(rng, batch + (N,)),
        c1=words(rng, batch + (L, N)), f1=words(rng, batch + (L, N)),
        noise_c0=words(rng, batch + (L, N)),
        noise_d0=words(rng, batch + (L, N)),
        noise_d1=words(rng, batch + (L, N)),
        noise_f0=words(rng, batch + (L, N)), tlwe_key=bits(rng, (1, N)),
        shared_a=words(rng, (L, N)), pk_b=words(rng, (L, N)))


def ue_pair(rng, batch=()):
    u = random_ue(rng, batch)
    want = j_mki.mk_tgsw_encrypt_core(
        *(jnp.asarray(v) for v in u.values()), L, B)
    got = p_mki.mk_tgsw_encrypt_core(
        *(torch.as_tensor(v) for v in u.values()), L, B)
    return got, want


@pytest.mark.parametrize("batch", [(), (5,)])
def test_mk_tgsw_encrypt_core(batch):
    got, want = ue_pair(np.random.default_rng(2), batch)
    assert tuple(got.cd.shape) == batch + (6, L, N)
    np.testing.assert_array_equal(got.cd.numpy(), np.asarray(want.cd))
    np.testing.assert_array_equal(got.f0.numpy(), np.asarray(want.f0))


@pytest.mark.parametrize("parties,party", [(2, 0), (2, 1), (4, 2)])
def test_expand_and_extern_operand(parties, party):
    rng = np.random.default_rng(3 + parties)
    got_ue, want_ue = ue_pair(rng, (4,))
    pk_bs = words(rng, (parties, L, N))
    want = j_mki.mk_tgsw_expand(want_ue, party, jnp.asarray(pk_bs), L, B)
    got = p_mki.mk_tgsw_expand(got_ue, party, tt_(pk_bs), L, B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    dense_w = j_mki.build_extern_operand(want, party, parties, L)
    dense_g = p_mki.build_extern_operand(got, party, parties, L)
    assert tuple(dense_g.shape) == (4, 4, (parties + 1) * L, parties + 1,
                                    2 * N)
    np.testing.assert_array_equal(dense_g.numpy(), np.asarray(dense_w))

    nz = p_mki.mk_nonzero_blocks(party, parties)
    sparse_w = j_mki.build_extern_operand_sparse(want, party, parties, L, nz)
    sparse_g = p_mki.build_extern_operand_sparse(got, party, parties, L, nz)
    np.testing.assert_array_equal(sparse_g.numpy(), np.asarray(sparse_w))
    # the blocks outside nz are zero words: their limbs are all zero
    kept = torch.zeros_like(dense_g, dtype=torch.bool)
    for j, k in nz:
        kept[..., j * L:(j + 1) * L, k, :] = True
    assert not dense_g[~kept].any()


def test_mk_keyswitch():
    rng = np.random.default_rng(5)
    parties, n_in, n_out, l, b, batch = 3, 32, 12, 4, 2, 6
    keys_j, keys_p = [], []
    for _ in range(parties):
        in_key, out_key = bits(rng, (n_in,)), bits(rng, (n_out,))
        a = words(rng, ((1 << b) - 1, l, n_in, n_out))
        noise = words(rng, ((1 << b) - 1, l, n_in)) >> 12
        keys_j.append(j_ks.keyswitch_key_core(
            jnp.asarray(in_key), jnp.asarray(out_key), jnp.asarray(a),
            jnp.asarray(noise), l, b, noise_stddev=1e-5))
        keys_p.append(p_ks.keyswitch_key_core(
            tt_(in_key), tt_(out_key), tt_(a), tt_(noise), l, b,
            noise_stddev=1e-5))
    a = words(rng, (2, batch // 2, parties, n_in))
    b_, cv = words(rng, (2, batch // 2)), np.full((2, batch // 2), 1e-6,
                                                  np.float32)
    want = j_mki.mk_keyswitch(keys_j, j_mki.MKLweSample(
        jnp.asarray(a), jnp.asarray(b_), jnp.asarray(cv)))
    got = p_mki.mk_keyswitch(keys_p,
                             interop.mk_lwe_sample_from_numpy(
                                 a, b_, cv, device="cpu"))
    assert tuple(got.a.shape) == (2, batch // 2, parties, n_out)
    assert_samples_equal(got, want)
    bad = dataclasses.replace(keys_p[1], decomp_length=l - 1)
    with pytest.raises(ValueError, match="geometries differ"):
        p_mki.mk_keyswitch([keys_p[0], bad, keys_p[2]], got)


def test_sample_arithmetic_phase_and_extract():
    rng = np.random.default_rng(6)
    parties, n, batch = 3, 10, 4
    raw = [(words(rng, (batch, parties, n)), words(rng, (batch,)),
            rng.random(batch).astype(np.float32)) for _ in range(2)]
    xj, yj = (j_mki.MKLweSample(*(jnp.asarray(v) for v in r)) for r in raw)
    xp, yp = (interop.mk_lwe_sample_from_numpy(*r, device="cpu") for r in raw)
    assert (xp.parties, xp.n) == (parties, n)
    for got, want in [(xp + yp, xj + yj), (xp - yp, xj - yj), (-xp, -xj),
                      (xp * 3, xj * 3), (2 * (xp + yp), 2 * (xj + yj))]:
        assert_samples_equal(got, want)
    keys = bits(rng, (parties, n))
    np.testing.assert_array_equal(
        p_mki.mk_lwe_phase(xp, tt_(keys)).numpy(),
        np.asarray(j_mki.mk_lwe_phase(xj, jnp.asarray(keys))))
    assert_samples_equal(
        p_mki.mk_lwe_noiseless_trivial(7, n, parties, (batch,),
                                       device="cpu"),
        j_mki.mk_lwe_noiseless_trivial(7, n, parties, (batch,)))
    mu = words(rng, (batch, N))
    triv_j = j_mki.mk_tlwe_noiseless_trivial(jnp.asarray(mu), parties)
    triv_p = p_mki.mk_tlwe_noiseless_trivial(tt_(mu), parties)
    np.testing.assert_array_equal(triv_p.a.numpy(), np.asarray(triv_j.a))
    acc = words(rng, (batch, parties + 1, N))
    cv = np.full((batch,), 2e-7, np.float32)
    assert_samples_equal(
        p_mki.mk_tlwe_extract_sample(
            interop.tlwe_sample_from_numpy(acc, cv, device="cpu")),
        j_mki.mk_tlwe_extract_sample(
            tt.tlwe.TLweSample(jnp.asarray(acc), jnp.asarray(cv))))


@pytest.mark.parametrize("knobs,block,sparse", [
    ({}, 16, False),                         # the CPU's T <= 64 bake
    (dict(mk_bake_budget=0), 0, False),      # prepared limbs
    (dict(mk_bake_budget=1000), 0, False),  # a budget nothing fits
    (dict(mk_sparse_limbs="1"), 0, True),    # nonzero blocks, per party
])
def test_mk_bootstrap_key_form_follows_knobs(knobs, block, sparse):
    rng = np.random.default_rng(7)
    parties, n_lwe, n = 2, 3, 32
    ue = [words(rng, (n_lwe, 6, L, n)) for _ in range(parties)]
    pk_bs = words(rng, (parties, L, n))
    with j_tuning.override(**knobs):
        want = j_mki.mk_bootstrap_key(
            [j_mki.MKTGswUESample(jnp.asarray(u)) for u in ue],
            jnp.asarray(pk_bs), L, B, noise_stddev=1e-9, balanced=True)
    with p_tuning.override(**knobs):
        got = p_mki.mk_bootstrap_key(
            [p_mki.MKTGswUESample(tt_(u)) for u in ue], tt_(pk_bs), L, B,
            noise_stddev=1e-9, balanced=True)
    if not knobs:
        block = want.block
        assert block in (16, 32, 64)
    assert (got.block, got.sparse) == (want.block, want.sparse) \
        == (block, sparse)
    want_f, got_f = bk_fields(want), bk_fields(got)
    if sparse:
        assert isinstance(got.limbs, tuple) and len(got.limbs) == parties
        for g, w in zip(got.limbs, want_f.pop("limbs")):
            np.testing.assert_array_equal(g.numpy(), w)
        got_f.pop("limbs")
    else:
        np.testing.assert_array_equal(got_f.pop("limbs"),
                                      want_f.pop("limbs"))
    assert got_f == want_f
    carried = interop.mk_bootstrap_key_from_numpy(**bk_fields(want),
                                                  device="cpu")
    assert carried.sparse == sparse and carried.device.type == "cpu"


def reference_ceremony(params, parties, seed):
    r_shared, *r_parties = jax.random.split(jax.random.PRNGKey(seed),
                                            1 + parties)
    shared = j_mk.make_shared_key(r_shared, params)
    sks, parts = [], []
    for r in r_parties:
        r_sk, r_part = jax.random.split(r)
        sks.append(tt.make_secret_key(r_sk, params))
        parts.append(j_mk.make_cloud_key_part(r_part, sks[-1], shared))
    return shared, sks, parts


def carry_parts(params_p, shared, sks, parts):
    """The reference's ceremony state as the port's types, through numpy."""
    shared_p = interop.shared_key_from_numpy(params_p, np.asarray(shared.a),
                                             device="cpu")
    sks_p = [interop.secret_key_from_numpy(params_p, np.asarray(sk.key),
                                           device="cpu")
             for sk in sks]
    parts_p = [interop.cloud_key_part_from_numpy(
        params_p, np.asarray(p.public_key), np.asarray(p.key_uni_enc.cd),
        fields(p.keyswitch_key), device="cpu") for p in parts]
    return shared_p, sks_p, parts_p


def carry_sample(s):
    return interop.mk_lwe_sample_from_numpy(*(np.asarray(v) for v in s),
                                            device="cpu")


@pytest.fixture(scope="module", params=[2, 4])
def toy_ceremony(request):
    """A ceremony made by tfhe_tpu on the toy preset, its inputs, the
    reference's NAND and MUX outputs (its default CPU path: the T <= 64
    bake), and the same state carried into the port."""
    parties = request.param
    params_j = j_mk.mktfhe_parameters_toy(parties)
    params_p = p_mk.mktfhe_parameters_toy(parties)
    shared, sks, parts = reference_ceremony(params_j, parties, 40 + parties)
    ck = j_mk.make_mk_cloud_key(parts)
    assert ck.bootstrap_key.block > 0
    xs = np.array([False, False, True, True])
    ys = np.array([False, True, False, True])
    zs = np.array([True, False, False, True])
    cts = [j_mk.mk_encrypt(jax.random.PRNGKey(i), sks, jnp.asarray(v))
           for i, v in enumerate((xs, ys, zs))]
    want_nand = j_mk.mk_gate_nand(ck, cts[0], cts[1])
    want_mux = j_mk.mk_gate_mux(ck, *cts)
    _, sks_p, parts_p = carry_parts(params_p, shared, sks, parts)
    ck_p = interop.mk_cloud_key_from_numpy(
        params_p, bk_fields(ck.bootstrap_key),
        [fields(k) for k in ck.keyswitch_keys], device="cpu")
    return dict(parties=parties, bits=(xs, ys, zs), sks_p=sks_p,
                parts_p=parts_p, ck_p=ck_p,
                cts_p=[carry_sample(c) for c in cts],
                want_nand=want_nand, want_mux=want_mux)


def test_gates_match_reference_through_interop(toy_ceremony):
    c = toy_ceremony
    xs, ys, zs = c["bits"]
    ck_p, cts = c["ck_p"], c["cts_p"]
    assert ck_p.bootstrap_key.block > 0 and ck_p.parties == c["parties"]
    nand = p_mk.mk_gate_nand(ck_p, cts[0], cts[1])
    assert_samples_equal(nand, c["want_nand"])
    np.testing.assert_array_equal(
        p_mk.mk_decrypt(c["sks_p"], nand).numpy(), ~(xs & ys))
    mux = p_mk.mk_gate_mux(ck_p, *cts)
    assert_samples_equal(mux, c["want_mux"])
    np.testing.assert_array_equal(
        p_mk.mk_decrypt(c["sks_p"], mux).numpy(), np.where(xs, ys, zs))
    # the server's assembly in the port, from the carried parts, gives the
    # reference's key
    ck_own = p_mk.make_mk_cloud_key(c["parts_p"])
    assert torch.equal(ck_own.bootstrap_key.limbs, ck_p.bootstrap_key.limbs)


PORT_PATHS = [  # (name, knobs at assembly and at the gate, form)
    ("prepared", dict(mk_bake_budget=0), "dense"),
    ("expand", dict(mk_bake_budget=0, mk_cmux="expand"), "dense"),
    ("expand full plan", dict(mk_bake_budget=0, mk_cmux="expand",
                              mk_progressive=False), "dense"),
    ("expand sparse-stored", dict(mk_sparse_limbs="1"), "sparse"),
    ("sparse-stored full plan", dict(mk_sparse_limbs="1",
                                     mk_progressive=False), "sparse"),
    ("chunk", dict(mk_bake_budget=0, mk_cmux="expand", mk_mega="1",
                   mk_chunk=4), "dense"),
    ("chunk sparse-stored", dict(mk_sparse_limbs="1", mk_mega="1",
                                 mk_chunk=8), "sparse"),
    ("compact", dict(mk_bake_budget=0, mk_cmux="expand", mk_compact="1"),
     "dense"),
    ("compact full plan", dict(mk_bake_budget=0, mk_cmux="expand",
                               mk_compact="1", mk_progressive=False),
     "dense"),
    ("compact sparse-stored", dict(mk_sparse_limbs="1", mk_compact="1"),
     "sparse"),
]


@pytest.mark.parametrize("name,knobs,form", PORT_PATHS,
                         ids=[p[0].replace(" ", "_") for p in PORT_PATHS])
def test_every_port_path_gives_the_reference_words(toy_ceremony, name, knobs,
                                                   form):
    c = toy_ceremony
    with p_tuning.override(**knobs):
        ck = p_mk.make_mk_cloud_key(c["parts_p"])
        bk = ck.bootstrap_key
        assert bk.block == 0 and bk.sparse == (form == "sparse")
        assert p_mki._use_mk_expand_kernel(bk) == (name != "prepared")
        nand = p_mk.mk_gate_nand(ck, c["cts_p"][0], c["cts_p"][1])
        assert_samples_equal(nand, c["want_nand"])
        if name in ("prepared", "compact", "compact sparse-stored"):
            assert_samples_equal(p_mk.mk_gate_mux(ck, *c["cts_p"]),
                                 c["want_mux"])


def test_compact_depth2_matches_reference_prepared():
    """N = 512: M = 4, Karatsuba depth 2, the production plan's shape. The
    reference's compact kernel cannot be compiled at depth 2 on the CPU, so
    the port's compact path is held against the reference's prepared
    path."""
    kw = dict(lwe_size=6, lwe_noise_stddev=2.0**-15,
              tlwe_polynomial_degree=512, tlwe_mask_size=1,
              bs_decomp_length=5, bs_log2_base=6, bs_noise_stddev=3.29e-10,
              ks_decomp_length=8, ks_log2_base=2, ks_noise_stddev=2.0**-15,
              max_parties=2)
    params_j, params_p = JParams(**kw), tp.SchemeParameters(**kw)
    shared, sks, parts = reference_ceremony(params_j, 2, 77)
    with j_tuning.override(mk_bake_budget=0, mk_cmux="prepared"):
        ck = j_mk.make_mk_cloud_key(parts)
        assert ck.bootstrap_key.block == 0
        xs = np.array([False, True, True])
        ys = np.array([True, True, False])
        ct_x = j_mk.mk_encrypt(jax.random.PRNGKey(1), sks, jnp.asarray(xs))
        ct_y = j_mk.mk_encrypt(jax.random.PRNGKey(2), sks, jnp.asarray(ys))
        want = j_mk.mk_gate_nand(ck, ct_x, ct_y)
    _, sks_p, _ = carry_parts(params_p, shared, sks, parts)
    ck_p = interop.mk_cloud_key_from_numpy(
        params_p, bk_fields(ck.bootstrap_key),
        [fields(k) for k in ck.keyswitch_keys], device="cpu")
    expand = dict(mk_cmux="expand")
    for knobs in (dict(expand, mk_compact="1"),
                  dict(expand, mk_compact="1", mk_progressive=False),
                  dict(expand, mk_mega="1", mk_chunk=3),
                  dict(mk_cmux="prepared")):
        with p_tuning.override(**knobs):
            got = p_mk.mk_gate_nand(ck_p, carry_sample(ct_x),
                                    carry_sample(ct_y))
        assert_samples_equal(got, want)
    np.testing.assert_array_equal(p_mk.mk_decrypt(sks_p, got).numpy(),
                                  ~(xs & ys))


def test_sparse_key_needs_the_expansion_geometry():
    bk = p_mki.MKBootstrapKey(
        (torch.zeros((1, 4, 7, L, 2 * N), dtype=torch.int8),) * 2, 2, 1, L,
        B, N, sparse=True)
    acc = interop.tlwe_sample_from_numpy(np.zeros((1, 3, N), np.int32),
                                         np.zeros((1,), np.float32),
                                         device="cpu")
    with pytest.raises(ValueError, match="only the expansion path"):
        p_mki.mk_blind_rotate(acc, bk, torch.zeros((1, 2, 1),
                                                   dtype=torch.int32))


@pytest.fixture(scope="module")
def own_ceremony():
    """The port's own 2-party ceremony on the toy preset."""
    gen = torch.Generator().manual_seed(11)
    params = p_mk.mktfhe_parameters_toy(2)
    shared = p_mk.make_shared_key(gen, params)
    sks = [tp.make_secret_key(gen, params) for _ in range(2)]
    parts = [p_mk.make_cloud_key_part(gen, sk, shared) for sk in sks]
    return gen, params, sks, parts, p_mk.make_mk_cloud_key(parts)


TRUTH = {
    "mk_gate_nand": lambda x, y: ~(x & y), "mk_gate_and": lambda x, y: x & y,
    "mk_gate_or": lambda x, y: x | y, "mk_gate_xor": lambda x, y: x ^ y,
    "mk_gate_xnor": lambda x, y: ~(x ^ y), "mk_gate_nor": lambda x, y: ~(x | y),
    "mk_gate_andny": lambda x, y: ~x & y, "mk_gate_andyn": lambda x, y: x & ~y,
    "mk_gate_orny": lambda x, y: ~x | y, "mk_gate_oryn": lambda x, y: x | ~y,
}


@pytest.mark.parametrize("name", sorted(TRUTH) + ["mk_gate_not",
                                                  "mk_gate_mux"])
def test_gate_truth_tables(own_ceremony, name):
    gen, params, sks, _, ck = own_ceremony
    xs = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], dtype=torch.bool)
    ys = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1], dtype=torch.bool)
    zs = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.bool)
    cx, cy, cz = (p_mk.mk_encrypt(gen, sks, v) for v in (xs, ys, zs))
    assert torch.equal(p_mk.mk_decrypt(sks, cx), xs)
    assert cx.a.shape == (8, 2, params.lwe_size)
    if name == "mk_gate_not":
        out, want = p_mk.mk_gate_not(ck, cx), ~xs
    elif name == "mk_gate_mux":
        out, want = p_mk.mk_gate_mux(ck, cx, cy, cz), torch.where(xs, ys, zs)
    else:
        out, want = getattr(p_mk, name)(ck, cx, cy), TRUTH[name](xs, ys)
    assert torch.equal(p_mk.mk_decrypt(sks, out), want)
    assert out.a.shape == cx.a.shape and bool(torch.isfinite(out.cv).all())


def test_distributed_decryption(own_ceremony):
    gen, _, sks, _, ck = own_ceremony
    xs = torch.tensor([0, 1, 1, 0], dtype=torch.bool)
    ys = torch.tensor([1, 1, 0, 0], dtype=torch.bool)
    out = p_mk.mk_gate_nand(ck, p_mk.mk_encrypt(gen, sks, xs),
                            p_mk.mk_encrypt(gen, sks, ys))
    shares = [p_mk.mk_partial_decrypt(gen, sk, out, i, smudging_stddev=1e-4)
              for i, sk in enumerate(sks)]
    assert torch.equal(p_mk.mk_combine_shares(out, shares), ~(xs & ys))
    with pytest.raises(ValueError, match="exactly one"):
        p_mk.mk_partial_decrypt(gen, sks[0], out, 0)
    with pytest.raises(ValueError, match="break the 1/8 decision margin"):
        p_mk.mk_partial_decrypt(gen, sks[0], out, 0, statistical_security=40)
    fresh = p_mk.mk_encrypt(gen, sks, xs)
    shares = [p_mk.mk_partial_decrypt(gen, sk, fresh, i,
                                      statistical_security=2.0)
              for i, sk in enumerate(sks)]
    assert torch.equal(p_mk.mk_combine_shares(fresh, shares), xs)
    blank = fresh._replace(cv=torch.zeros_like(fresh.cv))
    with pytest.raises(ValueError, match="no noise estimate"):
        p_mk.mk_partial_decrypt(gen, sks[0], blank, 0, statistical_security=2)


def test_ceremony_refuses_what_the_scheme_does_not_take(own_ceremony):
    gen, params, _, parts, _ = own_ceremony
    with pytest.raises(ValueError, match="parameters allow 2"):
        p_mk.make_mk_cloud_key(parts + parts[:1])
    with pytest.raises(ValueError, match="tlwe_mask_size = 1"):
        p_mk.make_shared_key(gen, dataclasses.replace(params,
                                                      tlwe_mask_size=2))
