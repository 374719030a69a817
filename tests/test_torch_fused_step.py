"""The port's fused Karatsuba CMUX step equals the reference's.

* `cmux_step_karatsuba_plain` against the reference's Pallas kernel
  `cmux_step_pallas_karatsuba` in interpret mode, at the shapes the
  reference's own test of that kernel uses, and against
  `tfhe_tpu.bootstrap.mux_rotate_karatsuba`; array-equal, no tolerance.
* An emulation of the CUDA kernel from its tables (`fused_tables`: the
  blocks of a persistent grid form the digit rows of their groups of rows,
  then run the dots of their (batch tile, column tile) units;
  `test_torch_expand_fused.emulate_fused_kernel`) against the plain
  version, at the plans the kernel must take.
* The tables themselves (every digit segment a product reads is written,
  the blocks' shares of rows and units), the dispatcher, what the wrapper
  refuses.
* On a CUDA card only: the kernel, on the K-major step, against the plain
  version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu.ops.pallas_cmux import cmux_step_pallas_karatsuba
from tfhe_tpu.tgsw import decomp_offset as j_decomp_offset
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch.ops import fused_step, kernel_wrappers, launches
from tfhe_tpu_torch.ops.blind_rotate import blind_rotate_plain, kernel_tables
from tfhe_tpu_torch.ops.dots import to_kmajor
from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba, karatsuba_plan
from tfhe_tpu_torch.tgsw import prepare_tgsw
from test_torch_expand_fused import emulate_fused_kernel

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n,l,b,t,batch,depth", [
    (64, 3, 7, 32, 8, 1),    # shallow plan, single digit limb
    (128, 3, 7, 32, 8, 2),   # M=4, depth 2
    (256, 3, 7, 32, 8, 3),   # M=8 full depth
    (256, 2, 10, 32, 8, 3),  # two digit limbs everywhere
    (256, 3, 7, 64, 4, 2),   # toy production block
])
def test_plain_step_matches_reference_kernel(n, l, b, t, batch, depth):
    rng = np.random.default_rng(n + l + depth)
    k1 = 2
    gsw = words(rng, (1, l, k1, k1, n))
    bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, block=t,
                                       depth=depth)
    bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, block=t,
                                       depth=depth)
    np.testing.assert_array_equal(bk_p.baked.numpy(), np.asarray(bk_j.baked))
    acc = words(rng, (batch, k1, n))
    bara = rng.integers(0, 2 * n, size=batch).astype(np.int32)
    bara[0] = 0  # the no-op lane

    want = cmux_step_pallas_karatsuba(
        jnp.asarray(acc), bk_j.baked[0], jnp.asarray(bara), n=n, k1=k1, l=l,
        b=b, t=t, plan=bk_j.plan, offset=j_decomp_offset(l, b),
        interpret=True)
    want_xla = j_bs.mux_rotate_karatsuba(
        jnp.asarray(acc), bk_j.baked[0], jnp.asarray(bara), l, b, t,
        bk_j.plan)
    acc_t = torch.from_numpy(acc)
    got = fused_step.cmux_step_karatsuba(
        acc_t, bk_p.baked[0], torch.from_numpy(bara), l=l, b=b, t=t,
        plan=bk_p.plan, balanced=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_xla))
    np.testing.assert_array_equal(acc_t.numpy(), acc)  # input untouched
    np.testing.assert_array_equal(got.numpy()[0], acc[0])  # bara == 0


PLANS = [  # k1, n, l, b, depth
    (5, 256, 2, 8, 1),    # 128_fast
    (2, 1024, 3, 7, 2),   # 128, 128_radix
    (2, 1024, 4, 6, 2),   # 128_radix_reliable
    (3, 512, 3, 7, 2),    # 128_pbs
    (2, 1024, 2, 10, 2),  # the 80-bit preset: int16 raw digits
    (9, 128, 2, 8, 0),    # 128_fast8: M = 1, one leaf
]


@pytest.mark.parametrize("k1,n,l,b,depth", PLANS)
def test_fused_tables_emulation_matches_plain(k1, n, l, b, depth):
    rng = np.random.default_rng(k1 * n + l)
    batch, t = 3, 128
    gsw = torch.from_numpy(words(rng, (1, l, k1, k1, n)))
    plan = karatsuba_plan(n // t, depth, b)
    e_step = bake_karatsuba(prepare_tgsw(gsw, l, b), t, plan)[0]
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara = torch.from_numpy(rng.integers(-n, n, (batch,)).astype(np.int32))
    bara[0] = 0
    kw = dict(l=l, b=b, t=t, plan=plan, balanced=(b == 8))
    want = fused_step.cmux_step_karatsuba_plain(acc, e_step, bara, **kw)
    # one short batch tile, on a card of 2 resident blocks
    got = emulate_fused_kernel(acc, to_kmajor(e_step), bara, **kw,
                               resident=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # and one step of the whole rotation is this step
    rot = blind_rotate_plain(acc, e_step[None], bara[None], **kw)
    np.testing.assert_array_equal(rot.numpy(), want.numpy())


@pytest.mark.parametrize("k1,n,l,b,depth", PLANS)
def test_segment_table_covers_what_the_terms_read(k1, n, l, b, depth):
    """Every digit segment a product of the fused tables reads is one the
    front half writes (raw for b <= 8, else a combo's limb), the products
    are the plan's terms each once, and the blocks' groups and units cover
    the rows and the (tile, column tile) pairs once."""
    t = 128
    plan = karatsuba_plan(n // t, depth, b)
    m, pt = plan.m, k1 * l * t
    combos, lhs_rows, tables, items = fused_step.fused_tables(plan, k1, l, t)
    _, terms, _, lhs_rows_k = kernel_tables(plan, k1 * l, t)
    assert lhs_rows == lhs_rows_k <= 128 and len(combos) <= 64
    written = set(range(m)) if b <= 8 else set()
    for dst, _, two, hi in combos:
        written |= {dst, hi} if two else {dst}
    expanded = []
    for a_off, b_off, npieces, chunks, shift, tb, te, _ in tables.products:
        assert npieces == 1 and a_off % pt == 0 and (chunks * 128) % pt == 0
        segs = range(a_off // pt, (a_off + chunks * 128) // pt)
        assert set(segs) <= written
        expanded += [(posm, segs[0], b_off // pt, len(segs), shift, sign)
                     for posm, sign in tables.targets[tb:te]]
    assert sorted(expanded) == sorted(terms)
    assert items == tuple((col, 0, len(tables.products), 0)
                          for col in range(k1 * 4))
    batch = 300  # 5 tiles, the last of 44 rows: 3 groups
    for resident in (1, 7, 264):
        blocks = fused_step.grid_blocks(batch, len(items), resident)
        rows = [r for i in range(blocks)
                for g in fused_step.block_groups(batch, blocks, i) for r in g]
        assert sorted(rows) == list(range(batch))
        units = [u for i in range(blocks)
                 for u in fused_step.block_units(batch, len(items), blocks,
                                                 i)]
        assert sorted(units) == [(tile, col) for tile in range(5)
                                 for col in range(k1 * 4)]


def test_dispatcher_and_refusals():
    plan = karatsuba_plan(2, 1, 7)
    acc = torch.zeros((2, 2, 256), dtype=torch.int32)
    e_step = torch.zeros((plan.total_rows * 2 * 3 * 128, 2 * 4 * 128),
                         dtype=torch.int8)
    bara = torch.zeros((2,), dtype=torch.int32)
    kw = dict(l=3, b=7, t=128, plan=plan, balanced=False)
    out = fused_step.cmux_step_karatsuba(acc, e_step, bara, **kw)  # CPU: plain
    assert torch.equal(out, acc) and out.data_ptr() != acc.data_ptr()
    before = launches(kernel_wrappers()).get("cmux_step_karatsuba", 0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.cmux_step_karatsuba_kernel(acc, to_kmajor(e_step), bara,
                                              **kw)
    with pytest.raises(ValueError, match="reference layout"):
        fused_step.cmux_step_karatsuba_kernel(acc, e_step, bara, **kw)
    assert launches(kernel_wrappers()).get("cmux_step_karatsuba", 0) \
        == before


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the presets' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(13)
    for k1, n, l, b, depth in PLANS[:5]:
        plan = karatsuba_plan(n // 128, depth, b)
        gsw = torch.from_numpy(words(rng, (1, l, k1, k1, n))).to(dev)
        e_step = bake_karatsuba(prepare_tgsw(gsw, l, b), 128, plan)[0]
        acc = torch.from_numpy(words(rng, (70, k1, n))).to(dev)
        bara = torch.from_numpy(
            rng.integers(-n, n, (70,)).astype(np.int32)).to(dev)
        kw = dict(l=l, b=b, t=128, plan=plan, balanced=(b == 8))
        got = fused_step.cmux_step_karatsuba(acc, to_kmajor(e_step), bara,
                                             **kw)
        want = fused_step.cmux_step_karatsuba_plain(acc, e_step, bara, **kw)
        assert torch.equal(got, want)
