"""The dots kernels launched in thread-block clusters along the batch
tile (csrc/cmux_kernels.cuh:launch_dots), on a CUDA card only:
`leaf_dots_kernel` and `mk_unit_dots_kernel` bit-equal to the plain
versions under the 128_fast and cggi128 (`tfhe_parameters_128`) Karatsuba
plans and the 2-party MK plans, at batches whose tiles pair up (clusters
of 2) and at batches whose tiles do not (plain launches). 128_fast (M = 2)
keeps 64-row blocks at every batch: B = 4096, 70 and 200 pair, B = 130
(three tiles) does not, B = 1 is one tile. At M = 8 (cggi128, MK) a block
owns 128 rows, two consumer warpgroups, past one 64-row tile
(`ops/dots.py:row_tile`): B = 4096 (32 tiles), B = 200 (a partial second
tile) and B = 130 (whose second tile's second warpgroup lies wholly past
the batch) pair, B = 70 is one tile, its columns cut into ranges that add
with atomics; B = 1 keeps 64 rows. `dots.clustered` counts the clustered
calls, `dots.row_tile.<r>` every call by its rows.
Imports no JAX, so that it runs on the card: `python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_dots_cluster.py -m cuda`.
"""

import pytest
import torch

from tfhe_tpu_torch import instrument
from tfhe_tpu_torch.mk.internals import active_plan
from tfhe_tpu_torch.ops import dots, mk_cmux
from tfhe_tpu_torch.ops.blind_rotate import (
    blind_rotate_kernel,
    blind_rotate_plain,
    dots_tables,
)
from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan, select_nz_limbs

T = 128
STEPS = 2
# name: K (k + 1), N, l, b, Karatsuba depth
SINGLE_KEY = {"128_fast": (5, 256, 2, 8, 1), "cggi128": (2, 1024, 3, 7, 2)}
MK_N, MK_L, MK_B = 1024, 5, 6  # the 2-party lownoise gadget


def rand_i32(gen, shape):
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device)


def rand_i8(gen, shape):
    return torch.randint(-128, 128, shape, dtype=torch.int8, generator=gen,
                         device=gen.device)


def rand_bara(gen, n, batch):
    return torch.randint(-n, n, (STEPS, batch), dtype=torch.int32,
                         generator=gen, device=gen.device)


def dots_calls(fn):
    """fn()'s result and the `dots.clustered` and `dots.row_tile.<r>`
    counts it added, as (clustered, {r: calls})."""
    prefix = "dots.row_tile."

    def counts():
        seen = instrument.counts()
        return seen.get("dots.clustered", 0), {
            int(k[len(prefix):]): n for k, n in seen.items()
            if k.startswith(prefix)}

    (clustered, rows), out = counts(), fn()
    clustered_after, rows_after = counts()
    return out, (clustered_after - clustered,
                 {r: n - rows.get(r, 0) for r, n in rows_after.items()
                  if n != rows.get(r, 0)})


def tile_of(m, batch):
    """(r, c): the rows of a dots block at M and this batch, and the
    blocks of the launch's clusters."""
    rows = dots.row_tile(m, batch)
    tiles = -(-batch // rows)
    cluster = dots.cluster_size(tiles)
    assert tiles % cluster == 0
    return rows, cluster


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4096, 70, 130, 1, 200])
def test_clustered_dots_match_plain_on_card(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(batch)

    for name, (k1, n, l, b, depth) in SINGLE_KEY.items():
        plan = karatsuba_plan(n // T, depth, b)
        rows, cluster = tile_of(n // T, batch)
        if batch == 70:  # each column cut into ranges (atomics)
            items = dots.work_items(dots_tables(plan, k1, l, T),
                                    -(-batch // rows), 2 * 132 * 64 // rows)
            assert any(it[3] for it in items), name
        key = rand_i8(gen, (STEPS, plan.total_rows * k1 * l * T, k1 * 4 * T))
        acc = rand_i32(gen, (batch, k1, n))
        bara_t = rand_bara(gen, n, batch)
        kw = dict(l=l, b=b, t=T, plan=plan, balanced=(b == 8))
        got, calls = dots_calls(lambda: blind_rotate_kernel(
            acc, dots.to_kmajor(key), bara_t, **kw))
        assert calls == (int(cluster > 1), {rows: 1}), name
        assert torch.equal(got, blind_rotate_plain(acc, key, bara_t, **kw)), \
            f"{name} B={batch} r={rows} c={cluster}"

    plan = karatsuba_plan(MK_N // T, 2, MK_B)
    rows, cluster = tile_of(MK_N // T, batch)
    for party in (0, 1):
        nz_orig, nz, _, k_act = active_plan(party, 2, True)
        dense = rand_i8(gen, (STEPS, 4, 3 * MK_L, 3, 2 * MK_N))
        limbs = select_nz_limbs(dense, nz_orig, MK_L)
        acc = rand_i32(gen, (batch, k_act, MK_N))
        bara_t = rand_bara(gen, MK_N, batch)
        kw = dict(l=MK_L, b=MK_B, t=T, plan=plan, nz=nz, balanced=False)
        e_chunk = torch.stack([mk_cmux.expand_sparse(
            limbs[s], t=T, plan=plan, nz=nz, l=MK_L, preselected=True)
            for s in range(STEPS)])  # K-major
        e_ref = dots.from_kmajor(e_chunk)
        want = mk_cmux.mk_blind_rotate_compact_plain(acc, limbs, bara_t,
                                                     **kw)
        what = f"2 parties, party {party}, B={batch} r={rows} c={cluster}"
        for fn in (mk_cmux.mk_blind_rotate_compact_kernel,
                   lambda acc, _, bara_t, **kw:
                   mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t,
                                                        **kw)):
            got, calls = dots_calls(lambda: fn(acc, limbs, bara_t, **kw))
            assert calls == (int(cluster > 1), {rows: 1}), what
            assert torch.equal(got, want), what
        got, calls = dots_calls(lambda: mk_cmux.cmux_step_sparse_kernel(
            acc, e_chunk[1], bara_t[1], **kw))
        assert calls == (int(cluster > 1), {rows: 1}), what
        assert torch.equal(got, mk_cmux.cmux_step_sparse_plain(
            acc, e_ref[1], bara_t[1], **kw)), what
