"""The port's multi-key CMUX (`ops/mk_cmux.py`) equals the reference's.

Inputs are made with numpy from a seed; every comparison is array-equal.

* `mk_nonzero_blocks` and the triangular rotation's `active_plan`;
* `sparse_plan` field by field against `_sparse_plan`, parties 2/4/8,
  depth 1-2;
* `expand_karatsuba_sparse`, both `preselected` modes;
* each plain version against its Pallas kernel in interpret mode, at the
  shapes of the reference's own tests (per-step and chunk: N = 256, T = 32,
  depth 2, 4 steps, batch 8; compact: N = 128, T = 32, depth 1, 3 steps),
  with the 2-party plans (an interpret-mode compile of a 4-party plan takes
  over a minute; its tables are covered by the two items around this one);
* an emulation of the CUDA kernels' arithmetic from their int tables
  (`kernel_tables` combos, `mk_product_tables` products as ops/dots.py
  encodes them, `entry_masks`) against the plain versions;
* `mk_product_tables`: no product twice, and its targets expand to exactly
  `mk_kernel_tables`' terms;
* which shapes the wrappers serve and which they refuse;
* on a CUDA card only: the kernels against their plain versions.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blind_rotate import emulate_dots

from tfhe_tpu.mk import internals as j_mki
from tfhe_tpu.ops import karatsuba as j_kar
from tfhe_tpu.ops import pallas_cmux as j_pc
from tfhe_tpu.tgsw import decomp_offset as j_decomp_offset
from tfhe_tpu_torch.mk import internals as p_mki
from tfhe_tpu_torch.ops import blind_rotate as p_br
from tfhe_tpu_torch.ops import compact, dots, mk_cmux
from tfhe_tpu_torch.ops import karatsuba as p_kar
from tfhe_tpu_torch.tgsw import decomp_offset

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clear_xla_cpu_state():
    """The interpret-mode MK modules are large; compiled state is dropped
    before every test, as the reference's own MK kernel tests do."""
    jax.clear_caches()
    yield


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("parties", [2, 4, 8])
def test_mk_nonzero_blocks_and_active_plan(parties):
    for party in range(parties):
        full = p_mki.mk_nonzero_blocks(party, parties)
        assert full == j_mki.mk_nonzero_blocks(party, parties)
        assert len(full) == 3 * parties + 1
        assert p_mki.active_plan(party, parties, False) == \
            (full, full, None, parties + 1)
        nz_orig, nz_kern, sel, k_act = p_mki.active_plan(party, parties, True)
        if party == parties - 1:
            assert (nz_orig, nz_kern, sel, k_act) == \
                (full, full, None, parties + 1)
            continue
        assert k_act == party + 2 and len(nz_kern) == 3 * party + 4
        assert tuple(full[pos] for pos in sel) == nz_orig
        active = set(range(party + 1)) | {parties}
        assert all(j in active and k in active for j, k in nz_orig)
        assert nz_kern == tuple((min(j, k_act - 1), min(k, k_act - 1))
                                for j, k in nz_orig)
        # every dropped block touches a component that is still zero
        assert all(j not in active or k not in active
                   for j, k in set(full) - set(nz_orig))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("parties,l,b", [(2, 4, 7), (2, 5, 6), (4, 5, 6),
                                         (8, 8, 4), (2, 2, 10)])
def test_sparse_plan_matches_reference(parties, l, b, depth):
    m, t = 8, 128
    k1 = parties + 1
    plan_j = j_kar.karatsuba_plan(m, depth, b)
    plan_p = p_kar.karatsuba_plan(m, depth, b)
    for party in (0, parties - 1):
        nz = p_mki.mk_nonzero_blocks(party, parties)
        want = j_pc._sparse_plan(plan_j, l, k1 * l, t, nz)
        got = mk_cmux.sparse_plan(plan_p, l, k1 * l, t, nz)
        assert got == want  # combo writes, every unit's fields, combo rows
        _, units, _ = got
        assert len(units) == len(plan_p.leaves) * len(nz)


@pytest.mark.parametrize("parties,party,l", [(2, 0, 4), (2, 1, 3), (4, 2, 2)])
@pytest.mark.parametrize("m,depth", [(2, 1), (4, 2), (8, 2)])
def test_expand_karatsuba_sparse(parties, party, l, m, depth):
    rng = np.random.default_rng(parties * 10 + m)
    t, log2_base = 8, 6
    n, k1 = m * t, parties + 1
    nz = p_mki.mk_nonzero_blocks(party, parties)
    limbs = i8(rng, (4, k1 * l, k1, 2 * n))
    plan_j = j_kar.karatsuba_plan(m, depth, log2_base)
    plan_p = p_kar.karatsuba_plan(m, depth, log2_base)
    want = np.asarray(j_kar.expand_karatsuba_sparse(
        jnp.asarray(limbs), t, plan_j, nz, l))
    got = p_kar.expand_karatsuba_sparse(torch.from_numpy(limbs), t, plan_p,
                                        nz, l)
    np.testing.assert_array_equal(got.numpy(), want)
    # a sparse-stored key holds exactly the selected blocks
    sel = p_kar.select_nz_limbs(torch.from_numpy(limbs), nz, l)
    assert tuple(sel.shape) == (4, len(nz), l, 2 * n)
    want_pre = np.asarray(j_kar.expand_karatsuba_sparse(
        jnp.asarray(sel.numpy()), t, plan_j, nz, l, preselected=True))
    np.testing.assert_array_equal(want_pre, want)
    got_pre = p_kar.expand_karatsuba_sparse(sel, t, plan_p, nz, l,
                                            preselected=True)
    assert torch.equal(got_pre, got)
    assert torch.equal(mk_cmux.expand_sparse(sel, t=t, plan=plan_p, nz=nz,
                                             l=l, preselected=True), got)
    with pytest.raises(ValueError, match="do not hold"):
        p_kar.expand_karatsuba_sparse(sel[:, 1:], t, plan_p, nz, l,
                                      preselected=True)


def mk_inputs(rng, parties, party, l, n, steps, batch, progressive=False):
    """Dense prepared limbs, the party's selection of them, accumulator and
    bara, as numpy."""
    nz_orig, nz_kern, _, k_act = p_mki.active_plan(party, parties,
                                                   progressive)
    k1 = parties + 1
    limbs = i8(rng, (steps, 4, k1 * l, k1, 2 * n))
    acc0 = words(rng, (batch, k_act, n))
    acc0[1, 0, :3] = [-(2**31), 2**31 - 1, -1]
    bara = rng.integers(0, 2 * n, (steps, batch)).astype(np.int32)
    bara[0, 0] = 0  # a lane that step 0 leaves unchanged
    sel = p_kar.select_nz_limbs(torch.from_numpy(limbs), nz_orig, l)
    return limbs, sel, acc0, bara, nz_orig, nz_kern, k_act


@pytest.mark.parametrize("parties,party,l,b", [(2, 0, 4, 7)])
def test_step_and_chunk_plain_match_pallas_interpret(parties, party, l, b):
    rng = np.random.default_rng(100 + parties)
    n, t, depth, steps, batch = 256, 32, 2, 4, 8
    limbs, sel, acc0, bara, nz, _, k1 = mk_inputs(rng, parties, party, l, n,
                                                  steps, batch)
    plan_j = j_kar.karatsuba_plan(n // t, depth, b)
    plan_p = p_kar.karatsuba_plan(n // t, depth, b)
    kw_j = dict(n=n, k1=k1, l=l, b=b, t=t, plan=plan_j, nz=nz,
                offset=j_decomp_offset(l, b), interpret=True)
    kw_p = dict(l=l, b=b, t=t, plan=plan_p, nz=nz, balanced=False)

    e_j = [j_kar.expand_karatsuba_sparse(jnp.asarray(limbs[s]), t, plan_j,
                                         nz, l) for s in range(steps)]
    e_p = torch.stack([mk_cmux.expand_sparse(sel[s], t=t, plan=plan_p, nz=nz,
                                             l=l, preselected=True)
                       for s in range(steps)])
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(jnp.stack(e_j)))

    want = jnp.asarray(acc0)
    got = torch.from_numpy(acc0)
    for s in range(steps):  # row 9: one step
        want = j_pc.cmux_step_pallas_sparse(want, e_j[s], bara[s], **kw_j)
        got = mk_cmux.cmux_step_sparse(got, e_p[s], torch.from_numpy(bara[s]),
                                       **kw_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        mk_cmux.cmux_step_sparse(torch.from_numpy(acc0), e_p[0],
                                 torch.from_numpy(bara[0]),
                                 **kw_p).numpy()[0], acc0[0])

    # row 7: the chunk
    want_c = j_pc.mk_blind_rotate_pallas_chunk(
        jnp.asarray(acc0), jnp.stack(e_j), jnp.asarray(bara), **kw_j)
    got_c = mk_cmux.mk_blind_rotate_chunk(
        torch.from_numpy(acc0), e_p, torch.from_numpy(bara), **kw_p)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert torch.equal(got_c, got)


@pytest.mark.parametrize("parties,party,l,b", [(2, 1, 4, 7)])
def test_compact_plain_matches_pallas_interpret(parties, party, l, b):
    rng = np.random.default_rng(200 + parties)
    n, t, depth, steps, batch = 128, 32, 1, 3, 8
    _, sel, acc0, bara, nz, _, k1 = mk_inputs(rng, parties, party, l, n,
                                              steps, batch)
    plan_j = j_kar.karatsuba_plan(n // t, depth, b)
    plan_p = p_kar.karatsuba_plan(n // t, depth, b)
    want = j_pc.mk_blind_rotate_pallas_compact(
        jnp.asarray(acc0), jnp.asarray(sel.numpy()), jnp.asarray(bara), n=n,
        k1=k1, l=l, b=b, t=t, plan=plan_j, nz=nz,
        offset=j_decomp_offset(l, b), interpret=True)
    got = mk_cmux.mk_blind_rotate_compact(
        torch.from_numpy(acc0), sel, torch.from_numpy(bara), l=l, b=b, t=t,
        plan=plan_p, nz=nz, balanced=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def emulate_mk_step(acc, e_step, bara, l, b, t, plan, nz, balanced):
    """One multi-key step as the CUDA kernels compute it: the digit row from
    the combo table (`digit_rows_plain`, rotate_decompose_kernel's
    function), then the products of
    mk_unit_dots_kernel, each once with its targets: at T = 128 from the
    encoded rows by work item (`emulate_dots`), at a toy T straight from
    `mk_product_tables`."""
    bsz, k1, n = acc.shape
    m, pt, lt, nzn = n // t, k1 * l * t, l * t, len(nz)
    combos, _, _, lhs_rows = p_br.kernel_tables(plan, k1 * l, t)
    products = mk_cmux.mk_product_tables(plan, l, k1, t, nz)
    offset = decomp_offset(l, b, balanced)

    a = acc.astype(np.int64) & 0xFFFFFFFF
    lhs = p_br.digit_rows_plain(
        torch.from_numpy(acc), torch.from_numpy(np.asarray(bara)), combos,
        lhs_rows, l=l, b=b, t=t, offset=offset).numpy().astype(np.int64)

    if t == dots.CHUNK:
        tables = dots.encode_multi_key(products, k1, m, pt, lt, nzn)
        out = emulate_dots(torch.from_numpy(a),
                           torch.from_numpy(lhs).to(torch.int8),
                           torch.from_numpy(e_step), tables, t=t,
                           poly_columns=False).numpy()
    else:
        e = e_step.astype(np.int64)  # [R*NZ*l*T, 4T]
        out = a.copy()
        for k_col, lhs_off, e_row, nseg, shift, targets in products:
            part = np.zeros((bsz, 4 * t), np.int64)
            for i in range(nseg):
                c0, r0 = lhs_off + i * pt, e_row + i * nzn * lt
                part += lhs[:, c0:c0 + lt] @ e[r0:r0 + lt]
            word = sum(part[:, q * t:(q + 1) * t] << (8 * q) for q in range(4))
            for posm, sign in targets:
                out[:, k_col, posm * t:(posm + 1) * t] += sign * (word << shift)
    out &= 0xFFFFFFFF
    return ((out ^ 0x80000000) - 0x80000000).astype(np.int32)


@pytest.mark.parametrize("parties,l,b", [(2, 5, 6), (4, 4, 7), (8, 2, 10)])
def test_mk_product_tables_once_each_and_expand_to_terms(parties, l, b):
    plan = p_kar.karatsuba_plan(8, 2, b)
    for party in (0, parties - 1):
        for progressive in (True, False):
            _, nz, _, k1 = p_mki.active_plan(party, parties, progressive)
            products = mk_cmux.mk_product_tables(plan, l, k1, 128, nz)
            keys = [pr[:5] for pr in products]
            assert len(set(keys)) == len(keys)  # no product twice
            expanded = collections.Counter(
                (k_col * plan.m + posm, lhs_off, e_row, nseg, shift, sign)
                for k_col, lhs_off, e_row, nseg, shift, targets in products
                for posm, sign in targets)
            terms, _ = mk_cmux.mk_kernel_tables(plan, l, k1, 128, nz)
            assert expanded == collections.Counter(map(tuple, terms))
            # executed = useful: every segment product of every unit, once
            assert sum(pr[3] for pr in products) == \
                plan.macs_superblocks * len(nz)


@pytest.mark.parametrize("parties,party,l,b,m,depth,progressive", [
    (2, 0, 5, 6, 8, 2, True),    # 2-party lownoise, party 0: K = 2, NZ = 4
    (2, 1, 4, 7, 8, 2, True),    # two-limb combos at b = 7
    (4, 1, 2, 6, 4, 2, True),
    (4, 3, 2, 6, 2, 1, False),
    (2, 1, 2, 10, 4, 2, False),  # b > 8: every leaf reads two-limb combos
    (8, 5, 2, 4, 2, 1, True),
])
def test_mk_table_emulation_matches_plain(parties, party, l, b, m, depth,
                                          progressive):
    rng = np.random.default_rng(parties + 10 * party + b)
    t, steps, batch = 8, 2, 3
    n = m * t
    _, sel, acc0, bara, _, nz_kern, _ = mk_inputs(
        rng, parties, party, l, n, steps, batch, progressive)
    bara[1, 1] = -3
    plan = p_kar.karatsuba_plan(m, depth, b)
    kw = dict(l=l, b=b, t=t, plan=plan, nz=nz_kern, balanced=(b == 6))
    want = mk_cmux.mk_blind_rotate_compact_plain(
        torch.from_numpy(acc0), sel, torch.from_numpy(bara), **kw).numpy()
    # the expansion is the compact key's kernel on [4, NZ*l, 1, 2N]
    masks = compact.entry_masks(plan)
    assert len(masks) == plan.total_rows
    got = acc0
    for s in range(steps):
        e_step = mk_cmux.expand_sparse(sel[s], t=t, plan=plan, nz=nz_kern,
                                       l=l, preselected=True)
        assert tuple(e_step.shape) == (
            mk_cmux.e_step_rows(plan, l, t, nz_kern), 4 * t)
        got = emulate_mk_step(got, e_step.numpy(), bara[s], **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parties,party,l,b,progressive", [
    (2, 1, 5, 6, True),   # 2-party lownoise, party 1: K = 3, NZ = 7
    (4, 3, 2, 10, False),  # b > 8, the full plan of the last party
])
def test_mk_encoded_tables_emulation_matches_plain(parties, party, l, b,
                                                   progressive):
    rng = np.random.default_rng(7 * parties + party)
    t, m, steps, batch = 128, 4, 1, 3
    n = m * t
    _, sel, acc0, bara, _, nz_kern, _ = mk_inputs(
        rng, parties, party, l, n, steps, batch, progressive)
    plan = p_kar.karatsuba_plan(m, 2, b)
    kw = dict(l=l, b=b, t=t, plan=plan, nz=nz_kern, balanced=False)
    want = mk_cmux.mk_blind_rotate_compact_plain(
        torch.from_numpy(acc0), sel, torch.from_numpy(bara), **kw).numpy()
    e_step = mk_cmux.expand_sparse(sel[0], t=t, plan=plan, nz=nz_kern, l=l,
                                   preselected=True)
    got = emulate_mk_step(acc0, e_step.numpy(), bara[0], **kw)
    np.testing.assert_array_equal(got, want)


def test_rotation_geometry_served_and_refused():
    plan = p_kar.karatsuba_plan(8, 2, 4)
    # every multi-key shape up to 8 parties: K = 2..9, P up to 72
    for k1, l, b in [(2, 5, 6), (3, 4, 7), (5, 5, 6), (9, 8, 4)]:
        m, pt = p_br.check_rotation_geometry(
            "test", k1, 1024, l, b, 128, p_kar.karatsuba_plan(8, 2, b))
        assert (m, pt) == (8, k1 * l * 128)
    # one staged accumulator row: 36,864 bytes at 8 parties, within the
    # 48 KB a block takes without the opt-in; N = 2048 at K = 9 opts in
    assert 9 * 1024 * 4 == 36864 <= 48 * 1024
    p_br.check_rotation_geometry("test", 9, 2048, 16, 2, 128,
                                 p_kar.karatsuba_plan(16, 2, 2))
    with pytest.raises(ValueError, match="232448 bytes of shared memory"):
        p_br.check_rotation_geometry(
            "test", 29, 2048, 1, 2, 128, p_kar.karatsuba_plan(16, 2, 2))
    with pytest.raises(ValueError, match="block T must be 128"):
        p_br.check_rotation_geometry("test", 3, 256, 4, 7, 32,
                                     p_kar.karatsuba_plan(8, 2, 7))
    with pytest.raises(ValueError, match="does not fit N"):
        p_br.check_rotation_geometry("test", 3, 512, 4, 4, 128, plan)


def test_mk_kernels_refuse_cpu_tensors_and_bad_blocks():
    plan = p_kar.karatsuba_plan(2, 1, 7)
    nz = p_mki.mk_nonzero_blocks(0, 2)
    acc = torch.zeros((2, 3, 256), dtype=torch.int32)
    bara_t = torch.zeros((1, 2), dtype=torch.int32)
    kw = dict(l=4, b=7, t=128, plan=plan, nz=nz, balanced=False)
    e_chunk = torch.zeros((1, mk_cmux.e_step_rows(plan, 4, 128, nz), 512),
                          dtype=torch.int8)
    limbs = torch.zeros((1, 4, len(nz), 4, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[0], bara_t[0], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        mk_cmux.mk_blind_rotate_compact_kernel(acc, limbs, bara_t, **kw)
    with pytest.raises(ValueError, match="do not fit 3 components"):
        mk_cmux._check_nz("test", ((0, 3),), 3)
    # on CPU tensors the dispatchers take the plain versions
    out = mk_cmux.mk_blind_rotate_compact(acc, limbs, bara_t, **kw)
    assert torch.equal(out, acc)


@pytest.mark.cuda
def test_mk_kernels_match_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(31)
    n, t, steps, batch = 1024, 128, 2, 70
    for parties, party, l, b, progressive in [(2, 0, 5, 6, True),
                                              (4, 3, 5, 6, False),
                                              (8, 5, 8, 4, False)]:
        _, sel, acc0, bara, _, nz, _ = mk_inputs(rng, parties, party, l, n,
                                                 steps, batch, progressive)
        plan = p_kar.karatsuba_plan(n // t, 2, b)
        kw = dict(l=l, b=b, t=t, plan=plan, nz=nz, balanced=False)
        acc, sel = torch.from_numpy(acc0).to(dev), sel.to(dev)
        bara_t = torch.from_numpy(bara).to(dev)
        e_chunk = torch.stack([mk_cmux.expand_sparse(
            sel[s], t=t, plan=plan, nz=nz, l=l, preselected=True)
            for s in range(steps)])  # K-major on the card
        e_ref = dots.from_kmajor(e_chunk)
        assert torch.equal(
            mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[1], bara_t[1], **kw),
            mk_cmux.cmux_step_sparse_plain(acc, e_ref[1], bara_t[1], **kw))
        with pytest.raises(ValueError, match="reference layout"):
            mk_cmux.cmux_step_sparse_kernel(acc, e_ref[1], bara_t[1], **kw)
        want = mk_cmux.mk_blind_rotate_chunk_plain(acc, e_ref, bara_t, **kw)
        assert torch.equal(mk_cmux.mk_blind_rotate_chunk_kernel(
            acc, e_chunk, bara_t, **kw), want)
        assert torch.equal(mk_cmux.mk_blind_rotate_compact_kernel(
            acc, sel, bara_t, **kw), want)
