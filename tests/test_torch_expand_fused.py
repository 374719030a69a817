"""The Hopper designs of the expansion kernel and the fused step, emulated
on the CPU from the tables and maps their kernels read.

* The expansion (`csrc/cmux_kernels.cuh:expand_kernel`): its work split
  and store map (`compact.expand_store_map`) write every output byte
  exactly once, in both layouts, at the shapes the paths run; the bytes the
  map takes from a block's kept limb bytes give `expand_step_plain`'s.
* The fused step (`csrc/fused_step.cu`): the persistent grid's blocks,
  the groups of rows each forms and the (batch tile, column tile) units
  and products each runs (`fused_step.fused_tables`, `block_groups`,
  `block_units`), add up to one step of `blind_rotate_plain`; every row is
  formed once, every output word written once, and at B = 4096 the units
  spread over one wave within 3%.
* The fused wrapper refuses a step in the reference layout before any
  launch.
* On a CUDA card only: both kernels against their plain versions.
"""

import collections

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.mk.internals import active_plan
from tfhe_tpu_torch.ops import compact, fused_step, kernel_wrappers, launches
from tfhe_tpu_torch.ops.blind_rotate import (
    blind_rotate_plain,
    digit_rows_plain,
)
from tfhe_tpu_torch.ops.conv import i8_matmul
from tfhe_tpu_torch.ops.dots import COL_TILE, ROW_TILE, to_kmajor
from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba, karatsuba_plan
from tfhe_tpu_torch.tgsw import decomp_offset, prepare_tgsw

torch.set_num_threads(2)
T = 128


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


# --- the expansion ---

def mk_shape(parties, party, l, b):
    """(total_rows, p_rows, k1) of a multi-key party's expansion: its NZ
    nonzero blocks of l rows, one column."""
    _, nz, _, _ = active_plan(party, parties, True)
    return karatsuba_plan(1024 // T, 2, b).total_rows, len(nz) * l, 1


EXPAND_SHAPES = {  # (total_rows, p_rows, k1)
    "128_fast8": (karatsuba_plan(1, 0, 8).total_rows, 9 * 2, 9),
    "128_fast_depth1": (karatsuba_plan(2, 1, 8).total_rows, 5 * 2, 5),
    "mk_2party_party0": mk_shape(2, 0, 5, 6),
    "mk_2party_party1": mk_shape(2, 1, 5, 6),
    "128_radix_reliable": (karatsuba_plan(8, 2, 6).total_rows, 2 * 4, 2),
}


@pytest.mark.parametrize("kmajor", [False, True])
@pytest.mark.parametrize("shape", sorted(EXPAND_SHAPES))
def test_expand_stores_write_each_byte_once(shape, kmajor):
    total_rows, p_rows, k1 = EXPAND_SHAPES[shape]
    units, dst, src = compact.expand_store_map(total_rows, p_rows, k1, kmajor)
    assert units.shape[0] == total_rows * p_rows * k1 * 4
    assert dst.shape == (units.shape[0], T * T // 16)
    size = total_rows * p_rows * T * k1 * 4 * T
    # aligned 16-byte stores whose starts are every multiple of 16 once:
    # each byte of the step's output is written exactly once
    flat = dst.flatten()
    assert (flat % 16 == 0).all()
    assert torch.equal(torch.sort(flat).values, torch.arange(0, size, 16))
    # a store takes 16 of the unit's 2T kept bytes; the fifth word it
    # reads ends inside the block's padded buffer (2T + 16 bytes)
    assert int(src.min()) >= 0 and int(src.max()) + 16 <= 2 * T
    assert int(src.max()) // 4 * 4 + 20 <= 2 * T + 16


def emulate_expand(limbs_step, plan, kmajor):
    """The expansion kernel's arithmetic from its store map: per unit the
    sums of aligned 4-byte plane words, the limb's balanced bytes, kept
    forward or reversed, then the map's 16-byte slices."""
    _, p_rows, k1, n2 = limbs_step.shape
    masks = compact.entry_masks(plan)
    units, dst, src = compact.expand_store_map(len(masks), p_rows, k1,
                                               kmajor)
    out = torch.full((len(masks) * p_rows * T * k1 * 4 * T,), 77,
                     dtype=torch.int8)
    planes = limbs_step.to(torch.int64)  # sign-extended bytes
    j = torch.arange(2 * T)
    for (r, pj, k, limb), d_row, s_row in zip(units.tolist(), dst, src):
        total = torch.zeros(2 * T, dtype=torch.int64)
        for d in range(32):
            if masks[r] >> d & 1:
                idx = (d * T - T + j) % n2
                total += sum(planes[pl, pj, k, idx] << (8 * pl)
                             for pl in range(4))
        cur = total & 0xFFFFFFFF
        cur = torch.where(cur >= 2**31, cur - 2**32, cur)
        for _ in range(limb):  # drop the lower balanced limbs
            lo = ((cur & 255) ^ 128) - 128
            cur = (cur - lo) >> 8
        kept = (cur & 255).to(torch.uint8)
        if kmajor:
            kept = kept.flip(0)
        kept = torch.cat([kept, torch.zeros(16, dtype=torch.uint8)])
        lines = kept[s_row[:, None] + torch.arange(16)]
        out[d_row[:, None] + torch.arange(16)] = lines.view(torch.int8)
    return out


@pytest.mark.parametrize("kmajor", [False, True])
def test_expand_store_map_gives_the_plain_bytes(kmajor):
    rng = np.random.default_rng(7 + kmajor)
    k1, n, l, depth = 2, 256, 2, 1
    plan = karatsuba_plan(n // T, depth, 8)
    limbs = torch.from_numpy(rng.integers(-128, 128, (4, k1 * l, k1, 2 * n))
                             .astype(np.int8))
    want = compact.expand_step_plain(limbs, t=T, plan=plan)
    if kmajor:
        want = to_kmajor(want)
    got = emulate_expand(limbs, plan, kmajor)
    assert torch.equal(got, want.flatten())


# --- the fused step ---

def emulate_fused_kernel(acc, key_km, bara, *, l, b, t, plan, balanced,
                         resident):
    """The fused kernel from its tables, block by block, on a card that
    holds `resident` blocks at once: phase 1 forms each block's groups of
    rows (`digit_rows_plain`, the front half's function) and counts them
    per batch tile, phase 2 runs each block's (tile, column tile) units,
    every product of the unit, against the tile's rows, and writes
    out = acc + sums once per word. Checks that every row is formed once,
    that a unit's tile has all its groups, every output word is written
    once and every product run once per unit."""
    bsz, k1, n = acc.shape
    m, pt = n // t, k1 * l * t
    combos, lhs_rows, tables, items = fused_step.fused_tables(plan, k1, l, t)
    offset = decomp_offset(l, b, balanced)
    blocks = fused_step.grid_blocks(bsz, len(items), resident)
    lhs = torch.zeros((bsz, lhs_rows * pt), dtype=torch.int8)
    formed = torch.zeros(bsz, dtype=torch.int64)
    ready = collections.Counter()
    for blk in range(blocks):
        for rows in fused_step.block_groups(bsz, blocks, blk):
            assert len(rows) <= fused_step.GROUP_ROWS
            lhs[rows] = digit_rows_plain(acc[rows], bara[rows], combos,
                                         lhs_rows, l=l, b=b, t=t,
                                         offset=offset)
            formed[rows] += 1
            ready[rows[0] // ROW_TILE] += 1
    written = torch.zeros((bsz, k1, n), dtype=torch.int64)
    ran = collections.Counter()
    out = torch.zeros((bsz, k1, n), dtype=torch.int64)
    for blk in range(blocks):
        for tile, col in fused_step.block_units(bsz, len(items), blocks, blk):
            rows = slice(tile * ROW_TILE, min((tile + 1) * ROW_TILE, bsz))
            n_rows = rows.stop - rows.start
            assert ready[tile] == -(-n_rows // fused_step.GROUP_ROWS)
            item_col, p0, p1, atomic = items[col]
            assert item_col == col and not atomic  # a unit's words alone
            k, wt = divmod(col, 4)
            sums = torch.zeros((m, n_rows, COL_TILE), dtype=torch.int64)
            for pi in range(p0, p1):
                a_off, b_off, npieces, chunks, shift, tb, te, _ = \
                    tables.products[pi]
                ran[(tile, col, pi)] += 1
                width = chunks * 128
                part = sum(
                    i8_matmul(lhs[rows, a_off + i * tables.a_stride:][
                        :, :width],
                        key_km[k, :, wt * COL_TILE:(wt + 1) * COL_TILE,
                               b_off + i * tables.b_stride:][..., :width]
                        .reshape(4 * COL_TILE, width).t())
                    .to(torch.int64) for i in range(npieces))
                part = part.reshape(-1, 4, COL_TILE)
                word = sum(part[:, x] << (8 * x) for x in range(4))
                for posm, sign in tables.targets[tb:te]:
                    sums[posm] += sign * (word << shift)
            for posm in range(m):
                c0 = posm * t + wt * COL_TILE
                cols = slice(c0, c0 + COL_TILE)
                out[rows, k, cols] = acc[rows, k, cols].to(torch.int64) \
                    + sums[posm]
                written[rows, k, cols] += 1
    assert (formed == 1).all() and (written == 1).all()
    assert set(ran.values()) == {1}
    assert len(ran) == -(-bsz // ROW_TILE) * k1 * 4 * len(tables.products)
    return (((out + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


FUSED_PLANS = {  # k1, n, l, b, depth
    "128_fast": (5, 256, 2, 8, 1),
    "128_pbs": (3, 512, 3, 7, 2),
    "128_radix": (2, 1024, 3, 7, 2),
    "128_radix_reliable": (2, 1024, 4, 6, 2),
    "80bit": (2, 1024, 2, 10, 2),  # int16 raw digits, never written
}


def fused_case(rng, k1, n, l, b, depth, batch):
    gsw = torch.from_numpy(words(rng, (1, l, k1, k1, n)))
    plan = karatsuba_plan(n // T, depth, b)
    e_step = bake_karatsuba(prepare_tgsw(gsw, l, b), T, plan)[0]
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara = torch.from_numpy(rng.integers(-n, n, (batch,)).astype(np.int32))
    bara[0] = 0
    return acc, e_step, bara, dict(l=l, b=b, t=T, plan=plan,
                                   balanced=(b == 8))


@pytest.mark.parametrize("preset", sorted(FUSED_PLANS))
def test_fused_blocks_add_up_to_one_rotation_step(preset):
    k1, n, l, b, depth = FUSED_PLANS[preset]
    rng = np.random.default_rng(k1 * n + l + b)
    # 70 rows: a ragged second batch tile of one short group; the H100
    # holds 2 blocks an SM up to M = 4, 1 at M = 8 (132 SMs)
    acc, e_step, bara, kw = fused_case(rng, k1, n, l, b, depth, 70)
    resident = 132 * (2 if n // T <= 4 else 1)
    got = emulate_fused_kernel(acc, to_kmajor(e_step), bara, **kw,
                               resident=resident)
    want = blind_rotate_plain(acc, e_step[None], bara[None], **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # at B = 4096 the units spread over one wave within 3%
    blocks = fused_step.grid_blocks(4096, k1 * 4, resident)
    shares = [len(fused_step.block_units(4096, k1 * 4, blocks, i))
              for i in range(blocks)]
    assert blocks == resident and sum(shares) == 64 * k1 * 4
    assert max(shares) <= 1.04 * sum(shares) / blocks
    assert 1 <= fused_step.stage_rows(k1, n, n // T) <= fused_step.GROUP_ROWS


def test_fused_kernel_refuses_the_reference_layout():
    k1, n, l, b, depth = FUSED_PLANS["128_fast"]
    rng = np.random.default_rng(3)
    acc, e_step, bara, kw = fused_case(rng, k1, n, l, b, depth, 4)
    before = launches(kernel_wrappers()).get("cmux_step_karatsuba", 0)
    with pytest.raises(ValueError, match="reference layout"):
        fused_step.cmux_step_karatsuba_kernel(acc, e_step, bara, **kw)
    with pytest.raises(ValueError, match="CUDA"):  # K-major, but on the CPU
        fused_step.cmux_step_karatsuba_kernel(acc, to_kmajor(e_step), bara,
                                              **kw)
    assert launches(kernel_wrappers()).get("cmux_step_karatsuba", 0) \
        == before


# --- on a CUDA card ---

@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the paths' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    for k1, n, l, depth in [(9, 128, 2, 0), (5, 256, 2, 1), (2, 1024, 4, 2)]:
        plan = karatsuba_plan(n // T, depth, 8)
        limbs = torch.from_numpy(rng.integers(
            -128, 128, (4, k1 * l, k1, 2 * n)).astype(np.int8)).cuda()
        want = compact.expand_step_plain(limbs, t=T, plan=plan)
        assert torch.equal(
            compact.expand_step_kernel(limbs, t=T, plan=plan), want)
        assert torch.equal(compact.expand_step_kernel(
            limbs, t=T, plan=plan, kmajor=True), to_kmajor(want))


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card_kmajor():
    """Needs a CUDA card and nvcc: the kernel on the K-major step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(12)
    for k1, n, l, b, depth in FUSED_PLANS.values():
        acc, e_step, bara, kw = fused_case(rng, k1, n, l, b, depth, 70)
        acc, e_step, bara = acc.cuda(), e_step.cuda(), bara.cuda()
        got = fused_step.cmux_step_karatsuba(acc, to_kmajor(e_step), bara,
                                             **kw)
        assert torch.equal(got, fused_step.cmux_step_karatsuba_plain(
            acc, e_step, bara, **kw))
