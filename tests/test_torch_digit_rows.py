"""The first launch of every rotation step on its own: the digit operand
(`ops/blind_rotate.py:digit_rows_plain`, `digit_rows_kernel`).

Inputs are made with numpy from a seed; every comparison is array-equal.

* `digit_rows_plain` against the reference's decomposition of
  (X^bara - 1) * acc (`tfhe_tpu.tgsw.decompose`, `polynomial.mul_by_monomial`)
  cut into T-blocks in lane order, and the masked block sums of
  `kernel_tables`' combos;
* the rotate/decompose kernel's store map (`digit_row_stores`): every byte
  of a row written once;
* an emulation of the kernel's packed-lane word arithmetic (two lanes per
  word for b <= 8, csrc/cmux_kernels.cuh) against `digit_rows_plain`;
* the packed combo table (`combo_words`);
* on a CUDA card only: the kernel and the dense step's rotate/decompose
  kernel against their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import polynomial as j_poly
from tfhe_tpu import tgsw as j_tgsw
from tfhe_tpu_torch.ops.blind_rotate import (
    combo_words,
    digit_row_defined,
    digit_row_stores,
    digit_rows_kernel,
    digit_rows_plain,
    kernel_tables,
    pack_combos,
)
from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan
from tfhe_tpu_torch.polynomial import mul_by_monomial
from tfhe_tpu_torch.tgsw import decomp_offset

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("k1,n,l,b,depth,balanced", [
    (5, 256, 2, 8, 1, True),     # 128_fast's plan
    (2, 1024, 3, 7, 2, True),    # N = 1024 at depth 2, two-limb combos
    (2, 1024, 2, 10, 2, False),  # b = 10: raw digits wider than a byte
    (3, 1024, 5, 6, 2, False),   # multi-key, 2-party lownoise party 1
])
def test_digit_rows_plain_matches_reference(k1, n, l, b, depth, balanced):
    rng = np.random.default_rng(k1 * l + b)
    t, batch = 128, 3
    m, pt = n // t, k1 * l * t
    acc = words(rng, (batch, k1, n))
    bara = rng.integers(-n, n, (batch,)).astype(np.int32)
    bara[:2] = [0, -5]  # the no-op and a negative rotation
    plan = karatsuba_plan(m, depth, b)
    combos, _, _, lhs_rows = kernel_tables(plan, k1 * l, t)
    got = digit_rows_plain(
        torch.from_numpy(acc), torch.from_numpy(bara), combos, lhs_rows, l=l,
        b=b, t=t, offset=decomp_offset(l, b, balanced)).numpy()
    assert got.shape == (batch, lhs_rows * pt) and got.dtype == np.int8
    got = got.reshape(batch, lhs_rows, pt).astype(np.int64)
    rot = j_poly.mul_by_monomial(jnp.asarray(acc), jnp.asarray(bara)[:, None])
    dig = np.asarray(j_tgsw.decompose(rot - jnp.asarray(acc), l, b, balanced))
    # [B, K, l, N] -> T-blocks in lane order [B, block i, (j, level, u)]
    dig = dig.reshape(batch, k1, l, m, t).transpose(0, 3, 1, 2, 4) \
        .reshape(batch, m, pt).astype(np.int64)
    if b <= 8:
        np.testing.assert_array_equal(got[:, :m], dig)
    else:  # not part of the function: the plain version leaves zeros
        assert digit_row_defined(b, m, pt) == m * pt
        assert not got[:, :m].any()
    assert not dig[0].any() and not got[0].any()  # bara = 0: all zero
    for dst, mask, two_limb, hi in combos:
        v = sum(dig[:, blk] for blk in range(m) if mask >> blk & 1)
        if two_limb:
            np.testing.assert_array_equal(got[:, dst] + 128 * got[:, hi], v)
            assert got[:, dst].min() >= -64 and got[:, dst].max() <= 63
        else:
            np.testing.assert_array_equal(got[:, dst], v)


@pytest.mark.parametrize("k1,n,l,b,depth", [
    (5, 256, 2, 8, 1),    # 128_fast
    (2, 1024, 3, 7, 2),   # 128_radix
    (3, 1024, 5, 6, 2),   # 2-party lownoise, party 1
    (2, 1024, 2, 10, 2),  # 80-bit: raw segments not written
])
def test_digit_row_stores_write_each_byte_once(k1, n, l, b, depth):
    t = 128
    m, pt = n // t, k1 * l * t
    combos, _, _, lhs_rows = kernel_tables(karatsuba_plan(m, depth, b),
                                           k1 * l, t)
    count = np.zeros(lhs_rows * pt, np.int64)
    for off in digit_row_stores(k1, n, l, b, combos, t):
        assert off % 4 == 0  # aligned 4-byte stores
        count[off:off + 4] += 1
    first = digit_row_defined(b, m, pt)
    assert (count[first:] == 1).all() and not count[:first].any()


def emulate_packed_rows(acc, bara, combos, lhs_rows, *, l, b, t, offset):
    """rotate_decompose_kernel's arithmetic for b <= 8 (csrc/cmux_kernels.cuh),
    in uint32 words: two lanes' biased digits per word (16-bit halves), the
    raw and combo bytes cut out of the halves."""
    bsz, k1, n = acc.shape
    m, pt, half, mask = n // t, k1 * l * t, 1 << (b - 1), (1 << b) - 1
    rot = mul_by_monomial(acc, bara.to(torch.int64)[:, None]).numpy()
    a = acc.numpy().astype(np.int64)
    shifted = (rot.astype(np.int64) - a + offset) & 0xFFFFFFFF
    out = np.zeros((bsz, lhs_rows, k1, l, t), np.uint32)

    def cut(word):  # low bytes of the halves, lanes 2q and 2q + 1
        word &= 0xFFFFFFFF
        return np.stack([word & 255, (word >> 16) & 255], -1).reshape(
            bsz, k1, t)

    for il in range(l):
        u = (shifted >> (32 - (il + 1) * b)) & mask  # [B, K, N]
        u = u.reshape(bsz, k1, m, t // 2, 2)
        e = u[..., 0] | u[..., 1] << 16  # [B, K, M, T/2]
        for i in range(m):
            out[:, i, :, il] = cut(e[:, :, i] + (0x100 - half) * 0x10001)
        for word in pack_combos(combos):
            blocks = [i for i in range(m) if word >> i & 1]
            w = ((0x1000 - len(blocks) * half) * 0x10001
                 + sum(e[:, :, i] for i in blocks)) & 0xFFFFFFFF
            dst, hi = (word >> 17) & 127, (word >> 24) & 127
            if not word >> 16 & 1:
                out[:, dst, :, il] = cut(w)
                continue
            x = (w & 0x007F007F) ^ 0x00400040
            h = ((w - x + 0x00400040) >> 7) & 0x007F007F
            out[:, dst, :, il] = cut(x + 0x00C000C0)
            out[:, hi, :, il] = cut(h + 0x00E000E0)
    return out.astype(np.uint8).view(np.int8).reshape(bsz, lhs_rows * pt)


@pytest.mark.parametrize("k1,n,l,b,depth,balanced", [
    (5, 256, 2, 8, 1, True),    # 128_fast
    (3, 512, 3, 7, 2, True),    # 128_pbs
    (2, 1024, 3, 7, 2, True),   # 128_radix: two-limb combos
    (3, 1024, 5, 6, 2, False),  # 2-party lownoise, party 1
    (9, 1024, 8, 4, 2, False),  # 8 parties
    (2, 2048, 2, 8, 3, False),  # M = 16: 38 combos of up to 8 blocks
])
def test_packed_lane_arithmetic_matches_plain(k1, n, l, b, depth, balanced):
    rng = np.random.default_rng(n + l + b)
    t, batch = 128, 2
    combos, _, _, lhs_rows = kernel_tables(karatsuba_plan(n // t, depth, b),
                                           k1 * l, t)
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara = torch.tensor([0, -77], dtype=torch.int32)
    kw = dict(l=l, b=b, t=t, offset=decomp_offset(l, b, balanced))
    np.testing.assert_array_equal(
        emulate_packed_rows(acc, bara, combos, lhs_rows, **kw),
        digit_rows_plain(acc, bara, combos, lhs_rows, **kw).numpy())


def test_combo_words_fit_the_kernel():
    for k1, n, l, b, depth in [(5, 256, 2, 8, 1), (9, 128, 2, 8, 0),
                               (2, 1024, 3, 7, 2), (2, 1024, 4, 6, 2),
                               (2, 1024, 2, 10, 2), (9, 1024, 8, 4, 2)]:
        m = n // 128
        combos, _, _, lhs_rows = kernel_tables(karatsuba_plan(m, depth, b),
                                               k1 * l, 128)
        words = combo_words(combos, m, lhs_rows)
        assert all(0 <= w < 2**31 for w in words)
        # hi_seg only where there is one
        assert all((w >> 24) == (hi if two else 0)
                   for w, (_, _, two, hi) in zip(words, combos))
    with pytest.raises(ValueError, match="does not fit"):
        combo_words([(2, 0b100, 0, 3)], 2, 4)  # a block past M
    with pytest.raises(ValueError, match="does not fit"):
        combo_words([(2, 0b11, 1, 4)], 2, 4)  # hi segment past the row


@pytest.mark.cuda
def test_digit_rows_kernel_and_dense_pair_match_plain_on_card():
    """Needs a CUDA card and nvcc: the rotate/decompose kernel alone and the
    dense step's rotate/decompose kernel against their plain versions, at
    ragged batches, b = 10 and K = 9; chip_smoke.py runs the same
    comparisons at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tfhe_tpu_torch.ops import cmux_step

    dev = "cuda"
    rng = np.random.default_rng(12)
    for k1, n, l, b, depth, batch in [(5, 256, 2, 8, 1, 300),
                                      (9, 128, 2, 8, 0, 70),
                                      (2, 1024, 3, 7, 2, 70),
                                      (2, 1024, 2, 10, 2, 17),
                                      (9, 1024, 4, 7, 2, 70)]:
        m, pt = n // 128, k1 * l * 128
        combos, _, _, lhs_rows = kernel_tables(karatsuba_plan(m, depth, b),
                                               k1 * l, 128)
        acc = torch.from_numpy(words(rng, (batch, k1, n))).to(dev)
        bara = torch.from_numpy(
            rng.integers(-n, n, (batch,)).astype(np.int32)).to(dev)
        bara[0] = 0
        kw = dict(l=l, b=b, t=128, offset=decomp_offset(l, b, b == 8))
        first = digit_row_defined(b, m, pt)
        got = digit_rows_kernel(acc, bara, combos, lhs_rows, **kw)
        want = digit_rows_plain(acc, bara, combos, lhs_rows, **kw)
        assert torch.equal(got[:, first:], want[:, first:])
        dkw = dict(l=l, b=b, t=128, balanced=(b == 8))
        assert torch.equal(
            cmux_step.rotate_decompose_kernel(bara, acc, **dkw).contiguous(),
            cmux_step.rotate_decompose_plain(bara, acc, **dkw))
