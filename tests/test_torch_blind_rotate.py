"""The port's blind rotation equals the reference's.

* `blind_rotate_plain` (through `bootstrap.blind_rotate`) against
  `tfhe_tpu.bootstrap.blind_rotate` on the CPU (the XLA path, which
  tests/test_pallas_cmux.py holds bit-equal to the Pallas kernels).
* An emulation of the CUDA kernels' table-driven arithmetic
  (`kernel_tables`' combos, `product_tables`' products as ops/dots.py
  encodes them and cuts them into work items, as csrc/blind_rotate.cu and
  csrc/dots_sm90.cuh read them) against `blind_rotate_plain`, at the plans
  the kernel must take.
* `product_tables`: no product twice, and its targets expand to exactly
  `kernel_tables`' terms.
* The K-major key layout (`ops/dots.py`): the relayout and its inverse, and
  an emulation of the dots kernel's tile addressing (TMA box, 128-byte
  swizzle, wgmma descriptor) that reads back the reference byte.
* The dots launches' cluster size (`ops/dots.py:cluster_size`) and the
  `dots.clustered` counter; the blocks an SM holds
  (`ops/dots.py:blocks_per_sm`) and the `dots.per_sm.<r>` counter, beside
  the batch rows of a block that each call counts (the rule itself, the
  launch order and the emulation over 128-row tiles:
  tests/test_torch_dots_tiles.py).
* On a CUDA card only: the kernel itself against the plain version
  (tests/test_torch_dots_cluster.py: the clustered launches).
"""

import collections


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import tlwe as j_tlwe
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import instrument, interop
from tfhe_tpu_torch.mk.internals import active_plan
from tfhe_tpu_torch.ops import dots, mk_cmux
from tfhe_tpu_torch.ops.blind_rotate import (
    blind_rotate_kernel,
    blind_rotate_plain,
    digit_rows_plain,
    dots_tables,
    kernel_tables,
    product_tables,
)
from tfhe_tpu_torch.ops.conv import i8_matmul
from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba, karatsuba_plan
from tfhe_tpu_torch.tgsw import decomp_offset, prepare_tgsw

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n,l,b,t,depth,k1", [
    (64, 2, 8, 32, 1, 5),     # the 128_fast family: k=4, M=2, b=8
    (256, 3, 7, 128, 1, 2),   # toy geometry: T=128, M=2
    (256, 3, 7, 32, 2, 2),    # M=8 at depth 2
    (128, 2, 10, 32, 2, 2),   # the 80-bit gadget: b=10, two-limb digits
    (64, 2, 10, 32, 1, 2),    # b=10 at depth 1
])
def test_blind_rotate_matches_reference(n, l, b, t, depth, k1):
    rng = np.random.default_rng(n + depth)
    n_lwe, batch = 4, 3
    gsw = words(rng, (n_lwe, l, k1, k1, n))
    acc0 = words(rng, (batch, k1, n))
    bara = rng.integers(0, 2 * n, (batch, n_lwe)).astype(np.int32)
    bara[0, :] = 0  # a lane whose every step is the no-op
    cv = np.full((batch,), 1e-6, np.float32)

    bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, block=t,
                                       depth=depth, noise_stddev=2.0**-25,
                                       balanced=(b == 8))
    bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, block=t,
                                       depth=depth, noise_stddev=2.0**-25,
                                       balanced=(b == 8))
    np.testing.assert_array_equal(bk_p.baked.numpy(), np.asarray(bk_j.baked))

    want = j_bs.blind_rotate(j_tlwe.TLweSample(jnp.asarray(acc0),
                                               jnp.asarray(cv)),
                             bk_j, jnp.asarray(bara))
    got = p_bs.blind_rotate(
        interop.tlwe_sample_from_numpy(acc0, cv, device="cpu"), bk_p,
                            torch.from_numpy(bara))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    assert np.array_equal(got.a.numpy()[0], acc0[0])  # bara == 0: unchanged


def emulate_dots(acc, lhs8, key, tables, *, t, poly_columns,
                 target_blocks=10_000, row_tile=None):
    """The dots kernel (csrc/dots_sm90.cuh) from its encoded tables, one
    block's unit at a time in the launch's order: acc int64[B, K, N]
    (returned updated, not wrapped), lhs8 the digit rows int8[B, stride],
    key the step in the reference layout [rows, K*4*T] (poly_columns: the
    item's k picks the key's poly) or [rows, 4*T] (multi-key). A large
    `target_blocks` cuts every column's products into small ranges, as
    small batches do. row_tile: the batch rows of a block (default: the
    kernels' rule at this batch, `dots.row_tile`), whose warpgroups own 64
    rows each and add only their rows below the batch."""
    bsz = acc.shape[0]
    rows = row_tile or dots.row_tile(tables.m, bsz)
    tiles = -(-bsz // rows)
    items = dots.work_items(tables, tiles, target_blocks)
    units = dots.launch_order(tables, items, tiles, dots.cluster_size(tiles))
    assert sorted(units) == sorted((*it, tile) for it in items
                                   for tile in range(tiles))
    covered, written = collections.Counter(), collections.Counter()
    out = acc.clone()
    for col, lo, hi, atomic, tile in units:
        k, wt = divmod(col, 4)
        own = [r for r0 in range(tile * rows, (tile + 1) * rows,
                                 dots.ROW_TILE)
               for r in range(r0, min(r0 + dots.ROW_TILE, bsz))]
        covered.update((tile, col, i) for i in range(lo, hi))
        written.update((r, col) for r in own)
        kk = k if poly_columns else 0
        cols = [kk * 4 * t + limb * t + wt * dots.COL_TILE + w
                for limb in range(4) for w in range(dots.COL_TILE)]
        for a_off, b_off, npieces, chunks, shift, tb, te, _ in \
                tables.products[lo:hi]:
            part = torch.zeros((len(own), 4 * dots.COL_TILE),
                               dtype=torch.int64)
            for i in range(npieces):
                a0 = a_off + i * tables.a_stride
                b0 = b_off + i * tables.b_stride
                width = chunks * dots.CHUNK
                part += i8_matmul(lhs8[own, a0:a0 + width],
                                  key[b0:b0 + width][:, cols]).to(torch.int64)
            part = part.reshape(len(own), 4, dots.COL_TILE)
            word = sum(part[:, limb] << (8 * limb) for limb in range(4))
            for posm, sign in tables.targets[tb:te]:
                c0 = posm * t + wt * dots.COL_TILE
                out[own, k, c0:c0 + dots.COL_TILE] += sign * (word << shift)
    # every column tile of every batch tile runs each of its column's
    # products exactly once, and its blocks own every row of the batch
    for tile in range(tiles):
        for k, (b, e) in enumerate(tables.columns):
            for wt in range(4):
                assert all(covered[(tile, 4 * k + wt, i)] == 1
                           for i in range(b, e))
    assert sum(covered.values()) == \
        tiles * 4 * sum(e - b for b, e in tables.columns)
    assert {r for r, _ in written} == set(range(bsz))
    return out


def emulate_kernel(acc, e_all, bara_t, *, l, b, t, plan, balanced,
                   row_tile=None):
    """The CUDA kernels' arithmetic, step by step, from their tables: the
    digit rows (`digit_rows_plain`, the first launch), then the dots."""
    bsz, k1, n = acc.shape
    m, pt = n // t, k1 * l * t
    combos, _, _, lhs_rows = kernel_tables(plan, k1 * l, t)
    tables = dots_tables(plan, k1, l, t)
    offset = decomp_offset(l, b, balanced)
    if b > 8:  # the raw segments are not part of the rows: no product reads
        assert all(pr[0] >= m * pt for pr in tables.products)
    acc = acc.to(torch.int64)
    for s in range(e_all.shape[0]):
        lhs8 = digit_rows_plain(acc.to(torch.int32), bara_t[s], combos,
                                lhs_rows, l=l, b=b, t=t, offset=offset)
        acc = emulate_dots(acc, lhs8, e_all[s], tables, t=t,
                           poly_columns=True, row_tile=row_tile)
        acc = ((acc + 2**31) & 0xFFFFFFFF) - 2**31
    return acc.to(torch.int32)


@pytest.mark.parametrize("k1,n,l,b,depth", [
    (5, 256, 2, 8, 1),   # 128_fast
    (2, 256, 3, 7, 1),   # toy
    (2, 1024, 3, 7, 2),  # N=1024 at depth 2, 9 leaves
    (2, 1024, 2, 10, 2),  # the 80-bit shape: b=10, every leaf two limbs
    (9, 128, 2, 8, 0),   # 128_fast8: M=1, one leaf, one row, K=9
])
def test_kernel_tables_emulation_matches_plain(k1, n, l, b, depth):
    rng = np.random.default_rng(k1 * n)
    n_lwe, batch, t = 2, 3, 128
    gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n)))
    # the operand the compact rotation expands: the plan's own bake, which
    # at depth 0 (M = 1) is not the dense key bootstrap_key_from_raw builds
    plan = karatsuba_plan(n // t, depth, b)
    baked = bake_karatsuba(prepare_tgsw(gsw, l, b), t, plan)
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara_t = torch.from_numpy(rng.integers(-n, n, (n_lwe, batch)).astype(np.int32))
    bara_t[:, 0] = 0
    kw = dict(l=l, b=b, t=t, plan=plan, balanced=(b == 8))
    want = blind_rotate_plain(acc, baked, bara_t, **kw)
    got = emulate_kernel(acc, baked, bara_t, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("m,depth,b", [(1, 0, 8), (2, 1, 8), (4, 2, 7),
                                        (8, 2, 7), (8, 2, 10), (8, 3, 6),
                                        (16, 2, 6), (16, 4, 7)])
def test_product_tables_once_each_and_expand_to_terms(m, depth, b):
    plan = karatsuba_plan(m, depth, b)
    p, t = 6, 128
    products = product_tables(plan, p, t)
    keys = [pr[:4] for pr in products]
    assert len(set(keys)) == len(keys)  # no product twice
    expanded = collections.Counter(
        (posm, lseg, eseg, nseg, shift, sign)
        for lseg, eseg, nseg, shift, targets in products
        for posm, sign in targets)
    _, terms, _, _ = kernel_tables(plan, p, t)
    assert expanded == collections.Counter(map(tuple, terms))
    # executed = useful: every segment product of the plan, once
    assert sum(pr[2] for pr in products) == plan.macs_superblocks
    assert all(len({posm for posm, _ in pr[4]}) == len(pr[4])
               for pr in products)


def tile_bytes(key_km, step, k, wt, b0, t=128):
    """Emulate the dots kernel's read of the key tile at contraction row b0:
    the TMA box {128, 32, 4, 1, 1} at {b0, wt*32, 0, k, step} written into
    a slot with the 128-byte swizzle, then read through the wgmma
    descriptor (8-row groups 1024 bytes apart, start advanced by 32 bytes
    per k32 slice). Returns [128 columns (limb, w), 128 bytes]."""
    box = key_km[step, k, :, wt * 32:(wt + 1) * 32, b0:b0 + 128]
    box = box.reshape(128, 128).numpy()  # box row = limb*32 + w, 128 bytes
    slot = np.zeros(128 * 128, np.int8)
    rows, byte = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    # TMA, SWIZZLE_128B: 16-byte chunk c of row r lands at chunk c ^ (r % 8)
    addr = rows * 128 + ((byte // 16) ^ (rows % 8)) * 16 + byte % 16
    slot[addr.reshape(-1)] = box.reshape(-1)
    out = np.zeros((128, 128), np.int8)
    for kk in range(4):  # the descriptor of slice kk starts 32*kk bytes on
        n_idx, kb = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
        lin = (n_idx // 8) * 1024 + (n_idx % 8) * 128 + 32 * kk + kb
        # the swizzle acts on the address: bits [4:7) ^= bits [7:10)
        phys = (lin & ~0x70) | ((((lin >> 4) & 7) ^ ((lin >> 7) & 7)) << 4)
        out[:, 32 * kk:32 * kk + 32] = slot[phys]
    return out


def test_kmajor_layout_round_trip_and_tile_addressing():
    rng = np.random.default_rng(5)
    n_steps, k1, t, rows = 2, 3, 128, 384
    ref = torch.from_numpy(rng.integers(-128, 128, (n_steps, rows,
                                                    k1 * 4 * t),
                                        dtype=np.int8))
    km = dots.to_kmajor(ref)
    assert tuple(km.shape) == (n_steps, k1, 4, t, rows)
    assert torch.equal(dots.from_kmajor(km), ref)
    assert torch.equal(dots.to_kmajor(ref[1]), km[1])
    inplace = dots.relayout_kmajor_(ref.clone())
    assert torch.equal(inplace, km)
    ref_np = ref.numpy()
    for step in range(n_steps):
        for k in range(k1):
            for wt in range(4):
                for b0 in range(0, rows, 128):
                    got = tile_bytes(km, step, k, wt, b0)
                    cols = [k * 4 * t + limb * t + wt * 32 + w
                            for limb in range(4) for w in range(32)]
                    want = ref_np[step, b0:b0 + 128][:, cols].T
                    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="reference layout"):
        dots.require_kmajor("test", ref, (n_steps,), k1, t, rows)
    dots.require_kmajor("test", km, (n_steps,), k1, t, rows)


def test_work_items_fill_the_card_and_cut_only_where_short():
    # 128_fast at B = 4096: 1280 blocks of whole columns, no atomics
    tables = dots_tables(karatsuba_plan(2, 1, 8), 5, 2, 128)
    items = dots.work_items(tables, 64, 2 * 2 * 132)
    assert len(items) == 20 and not any(it[3] for it in items)
    # the 80-bit preset at B = 256 (4 tiles): columns cut to fill two waves
    tables = dots_tables(karatsuba_plan(8, 2, 10), 2, 2, 128)
    items = dots.work_items(tables, 4, 2 * 132)
    assert len(items) * 4 >= 2 * 132 and all(it[3] for it in items)
    slots = [sum(tables.slots(i) for i in range(lo, hi))
             for _, lo, hi, _ in items]
    assert slots == sorted(slots, reverse=True)  # heaviest first
    # the ring and M blocks' sums fit one block's shared memory up to M = 16
    for m in (1, 2, 4, 8, 16):
        stages = dots.ring_stages(m)
        assert 3 <= stages <= 6
        assert dots.smem_bytes(m, stages) <= 227 * 1024
    assert dots.smem_bytes(2, dots.ring_stages(2)) + 1024 <= 114 * 1024
    # two warpgroups' sums beside 3 slots of 32 KB at M = 8; not at M = 16
    wide = dots.WIDE_ROW_TILE
    assert dots.ring_stages(8, wide) == 3
    assert dots.smem_bytes(8, 3, wide) == 229_424 <= 227 * 1024
    with pytest.raises(ValueError, match="3-slot ring"):
        dots.ring_stages(16, wide)
    # B = 4096 in 128-row tiles, cut for 132 blocks of two warpgroups:
    # cggi128 and both mk2 parties keep whole columns, no atomics
    tables = dots_tables(karatsuba_plan(8, 2, 7), 2, 3, 128)
    items = dots.work_items(tables, 32, 132)
    assert len(items) == 8 and not any(it[3] for it in items)
    plan = karatsuba_plan(8, 2, 6)
    for party, n_items in ((0, 8), (1, 12)):
        _, nz, _, k_act = active_plan(party, 2, True)
        items = dots.work_items(
            mk_cmux._mk_dots_tables(plan, 5, k_act, 128, nz), 32, 132)
        assert len(items) == n_items and not any(it[3] for it in items)


@pytest.mark.parametrize("tiles,cluster", [(1, 1), (2, 2), (3, 1),
                                           (64, 2)])
def test_cluster_pairs_batch_tiles_and_counts_clustered(tiles, cluster,
                                                       monkeypatch):
    """The dots launches' cluster size follows the batch tiles alone,
    divides them, reaches the C entry in the dots struct, and a
    clustered call counts once in `dots.clustered`."""
    assert dots.cluster_size(tiles) == cluster and tiles % cluster == 0
    monkeypatch.setattr(dots, "_sm_count", lambda device: 132)
    tables = dots_tables(karatsuba_plan(2, 1, 8), 5, 2, 128)  # 128_fast
    instrument.reset()
    for _ in range(3):
        args = dots.dots_args(tables, tiles * dots.ROW_TILE - 5, "cpu")
        assert args.cluster == cluster
    assert instrument.counts().get("dots.clustered", 0) == \
        (3 if cluster > 1 else 0)
    instrument.reset()


@pytest.mark.parametrize("n_poly,depth,per_sm", [(256, 1, 2),
                                                  (1024, 2, 1)])
def test_blocks_per_sm_follow_m_and_count_per_call(n_poly, depth, per_sm,
                                                   monkeypatch):
    """At M = 2 (128_fast) two dots blocks share an SM, at M = 8 (the
    128-bit preset) one; each C entry call counts once in
    `dots.per_sm.<r>` and the work items are cut for r blocks an SM."""
    m = n_poly // 128
    assert dots.blocks_per_sm(m) == per_sm
    assert per_sm * (dots.smem_bytes(m, dots.ring_stages(m)) + 1024) \
        <= 228 * 1024
    monkeypatch.setattr(dots, "_sm_count", lambda device: 132)
    k1, l, b = (5, 2, 8) if m == 2 else (2, 3, 7)
    tables = dots_tables(karatsuba_plan(m, depth, b), k1, l, 128)
    rows = dots.row_tile(m, 4096)  # 64 at M = 2, 128 at M = 8
    instrument.reset()
    for _ in range(3):
        args = dots.dots_args(tables, 4096, "cpu")
    seen = {k: n for k, n in instrument.counts().items()
            if k.startswith("dots.")}
    assert seen == {"dots.clustered": 3, f"dots.per_sm.{per_sm}": 3,
                    f"dots.row_tile.{rows}": 3}
    items = dots.work_items(tables, 4096 // rows,
                            2 * per_sm * 132 * 64 // rows)
    assert args.n_items == len(items) * 4096 // rows  # a block a unit
    assert args.row_tile == rows
    assert args.stages == dots.ring_stages(m, rows)
    instrument.reset()


def test_kernel_refuses_cpu_tensors():
    gsw = torch.zeros((1, 3, 2, 2, 256), dtype=torch.int32)
    bk = p_bs.bootstrap_key_from_raw(gsw, 3, 7)
    acc = torch.zeros((2, 2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        blind_rotate_kernel(acc, bk.baked, torch.zeros((1, 2), dtype=torch.int32),
                            l=3, b=7, t=128, plan=bk.plan, balanced=False)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(11)
    for k1, n, l, b, n_lwe, batch in [(5, 256, 2, 8, 3, 300),
                                      (2, 256, 3, 7, 3, 17),
                                      (2, 1024, 2, 10, 2, 17)]:
        gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n))).to(dev)
        bk = p_bs.bootstrap_key_from_raw(gsw, l, b)
        assert bk.depth >= 1 and bk.layout == "kmajor"
        acc = torch.from_numpy(words(rng, (batch, k1, n))).to(dev)
        bara_t = torch.from_numpy(
            rng.integers(-n, n, (n_lwe, batch)).astype(np.int32)).to(dev)
        kw = dict(l=l, b=b, t=bk.block, plan=bk.plan, balanced=(b == 8))
        got = blind_rotate_kernel(acc, bk.baked, bara_t, **kw)
        ref = dots.from_kmajor(bk.baked)
        want = blind_rotate_plain(acc, ref, bara_t, **kw)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="reference layout"):
            blind_rotate_kernel(acc, ref, bara_t, **kw)

