"""The dots' batch tile and launch order (`ops/dots.py`), on the CPU.

* `row_tile`: 128 rows a block (two consumer warpgroups) at M = 8 past one
  64-row tile, else 64; the tile reaches the C entry's struct, and each C
  call counts once in `dots.row_tile.<r>`.
* `launch_order`: every (work item, batch tile) unit once, the heaviest
  items first over all tiles, a cluster's tiles side by side.
* The emulation of the dots kernels (`test_torch_blind_rotate.py:
  emulate_kernel`) over 128-row tiles at cggi128's shape, against
  `blind_rotate_plain`.

The kernels themselves against the plain versions at these tiles:
tests/test_torch_dots_cluster.py, on a CUDA card.
"""

import numpy as np
import pytest
import torch

from test_torch_blind_rotate import emulate_kernel, words
from tfhe_tpu_torch import instrument
from tfhe_tpu_torch.mk.internals import active_plan
from tfhe_tpu_torch.ops import dots, mk_cmux
from tfhe_tpu_torch.ops.blind_rotate import blind_rotate_plain, dots_tables
from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba, karatsuba_plan
from tfhe_tpu_torch.tgsw import prepare_tgsw

torch.set_num_threads(2)


@pytest.mark.parametrize("m,batch,rows", [
    (8, 65, 128), (8, 130, 128), (8, 4096, 128),  # cggi128, mk2: M = 8
    (2, 4096, 64),  # fast128: two 64-row blocks an SM already
    (16, 4096, 64),  # two warpgroups' sums leave no 3-slot ring
    (8, 1, 64), (8, 64, 64),  # one 64-row tile: the b1 cells
])
def test_row_tile_follows_m_and_batch_and_counts_per_call(m, batch, rows,
                                                          monkeypatch):
    """A dots block owns 128 rows (two consumer warpgroups) where the
    64-row block is alone on its SM, two warpgroups' sums fit beside a
    3-slot ring, and the batch has more than one 64-row tile; else 64. The
    tile reaches the C entry in the dots struct, the batch tiles of that
    size pair into clusters, and each C call counts once in
    `dots.row_tile.<r>`."""
    assert dots.row_tile(m, batch) == rows
    monkeypatch.setattr(dots, "_sm_count", lambda device: 132)
    depth, b = {2: (1, 8), 8: (2, 7), 16: (2, 6)}[m]
    tables = dots_tables(karatsuba_plan(m, depth, b), 2, 3, 128)
    instrument.reset()
    args = dots.dots_args(tables, batch, "cpu")
    args = dots.dots_args(tables, batch, "cpu", calls=2)
    assert (args.row_tile, args.cluster) == \
        (rows, dots.cluster_size(-(-batch // rows)))
    assert dots.smem_bytes(m, args.stages, rows) <= 227 * 1024
    seen = {k: n for k, n in instrument.counts().items()
            if k.startswith("dots.row_tile.")}
    assert seen == {f"dots.row_tile.{rows}": 3}
    instrument.reset()


@pytest.mark.parametrize("parties,party,tiles,cluster", [
    (None, None, 64, 2),  # cggi128 in 64-row tiles: equal items
    (None, None, 3, 1),
    (2, 0, 32, 2),  # mk2 in 128-row tiles: party 0's equal items
    (2, 1, 32, 2),  # party 1: 8 items of 540 slots, then 4 of 180
    (2, 1, 1, 1),  # one tile: the items' own order
])
def test_launch_order_runs_heaviest_items_first(parties, party, tiles,
                                                cluster):
    """Every (item, batch tile) unit once, a row (k*4 + wt, begin, end,
    atomic, tile) a block; the heaviest items first over all tiles; a
    cluster's tiles side by side; items of one weight in the order of a grid
    of items by tiles, as a two-dimensional launch ran them."""
    if parties is None:
        tables = dots_tables(karatsuba_plan(8, 2, 7), 2, 3, 128)
    else:
        _, nz, _, k_act = active_plan(party, parties, True)
        tables = mk_cmux._mk_dots_tables(karatsuba_plan(8, 2, 6), 5, k_act,
                                         128, nz)
    items = dots.work_items(tables, tiles, 132)
    units = dots.launch_order(tables, items, tiles, cluster)
    assert sorted(units) == sorted((*it, tile) for it in items
                                   for tile in range(tiles))
    weight = [sum(tables.slots(i) for i in range(lo, hi))
              for _, lo, hi, _, _ in units]
    assert weight == sorted(weight, reverse=True)
    for a, b in zip(units[::cluster], units[cluster - 1::cluster]):
        assert a[:4] == b[:4] and a[4] + cluster - 1 == b[4]
    if len(set(weight)) == 1:  # a grid of items by tiles, clusters paired
        assert list(units) == [
            (*it, pair * cluster + r) for pair in range(tiles // cluster)
            for it in items for r in range(cluster)]


@pytest.mark.parametrize("batch,row_tile", [(130, None), (200, None),
                                           (3, 128), (130, 64)])
def test_kernel_tables_emulation_over_row_tiles(batch, row_tile):
    """The emulation at cggi128's shape (N = 1024, M = 8) over the batch
    tiles a launch takes: the rule's 128 rows past one 64-row tile (B =
    130: the second tile's second warpgroup lies past the batch; B = 200),
    a 128-row tile of which only the first warpgroup's rows exist, and the
    64-row tile at the same batch."""
    k1, n, l, b, depth, t = 2, 1024, 3, 7, 2, 128
    if row_tile is None:
        assert dots.row_tile(n // t, batch) == dots.WIDE_ROW_TILE
    rng = np.random.default_rng(batch)
    gsw = torch.from_numpy(words(rng, (1, l, k1, k1, n)))
    plan = karatsuba_plan(n // t, depth, b)
    baked = bake_karatsuba(prepare_tgsw(gsw, l, b), t, plan)
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara_t = torch.from_numpy(
        rng.integers(-n, n, (1, batch)).astype(np.int32))
    kw = dict(l=l, b=b, t=t, plan=plan, balanced=False)
    want = blind_rotate_plain(acc, baked, bara_t, **kw)
    got = emulate_kernel(acc, baked, bara_t, row_tile=row_tile, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
