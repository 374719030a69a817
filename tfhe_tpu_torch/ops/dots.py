"""What the int8 dots kernels read (`csrc/dots_sm90.cuh`): the K-major key
layout, the product tables as int rows, and the launch geometry.

The key layout. The reference lays a baked, dense or expanded key step out
as int8[rows, K*4*T]: contraction rows by output columns (poly k, limb,
coefficient w). `wgmma` takes 8-bit operands from shared memory only
K-major, so the kernels read every step as int8[K, 4, T, rows]: for each
output column its `rows` contraction bytes contiguous (`to_kmajor`). A key
that reaches the card is relaid once, in place and step by step
(`relayout_kmajor_`), so device memory never holds two copies of it. The
layout is recorded in the key's shape: a K-major key has the two more
dimensions, and every wrapper checks it and raises on the other (it never
converts quietly).

The tables. A lowering (`blind_rotate.product_tables`,
`mk_cmux.mk_product_tables`, `cmux_step.dense_product_tables`) lists each
distinct product once with its targets (output block, sign). `encode_*`
turn a lowering into the kernel's rows; `dots_args` adds the work items,
the ring depth and the cluster size, puts the rows on the device and fills
`DotsArgs`, the struct every C entry takes for its dots launches.

Work items. A block owns one column tile (poly k, 32 coefficients, four
limbs) of one batch tile of 64 or 128 rows (`row_tile`) for all M output
blocks, and a range of its column's products (`work_items`). A column's
products are cut into several ranges, whose blocks then add into acc with
atomics (exact for integers), only where that fills the card better: when
the batch is small, or when one column has many more products than the
others (the multi-key columns of the last parties).

Launch order. A launch's blocks run one unit each, a work item of one
batch tile, in the order of a table (`launch_order`): the heaviest items
first over all batch tiles, so that no heavy block starts last.

Clusters. The blocks of one work item over different batch tiles read the
same key tiles in the same order. Where the batch tiles pair up, a launch
runs them as thread-block clusters of two blocks along the batch tile
(`cluster_size`), which the card schedules together; `dots_args` counts
such a call in the `dots.clustered` counter of `instrument`.

Occupancy. The ring and the M blocks' sums set a block's shared memory,
and so how many 64-row blocks an SM holds at once (`blocks_per_sm`: 2 at
M <= 4, 1 from M = 8); the work items are cut for that many. `dots_args`
counts each call in `dots.per_sm.<r>` by that number r.

The row tile. A 64-row block has one consumer warpgroup. Where that block
is alone on its SM anyway, a block of 128 rows runs two warpgroups on each
key tile it loads (`row_tile`): the key feed per operation falls by a
third, and one warpgroup's queued products keep the tensor cores busy
while the other drains its own. `dots_args` counts each call in
`dots.row_tile.<r>` by the rows r of its tile.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..instrument import cached_build, count

CHUNK = 128  # contraction bytes per ring slot (one 128-byte swizzle row)
ROW_TILE = 64  # batch rows of a consumer warpgroup: the wgmma M
WIDE_ROW_TILE = 2 * ROW_TILE  # batch rows of a block of two warpgroups
COL_TILE = 32  # coefficients per column tile, per limb (wgmma N = 128)
SUMS_BYTES = ROW_TILE * COL_TILE * 4  # a warpgroup's word sums of a block
_SM_SMEM = 228 * 1024  # shared memory of one SM
_BLOCK_SMEM = 227 * 1024  # what one block may opt in to
_RESERVED = 1024  # per block, by the system
_MIN_SLOTS = 32  # a cut range holds at least this many slots of work
_WAVES = 2  # blocks to aim for, in full waves of resident blocks


# --- the K-major key layout ---


def to_kmajor(key: torch.Tensor, t: int = 128) -> torch.Tensor:
    """int8[..., rows, K*4*T] -> int8[..., K, 4, T, rows], contiguous."""
    *lead, rows, cols = key.shape
    k1 = cols // (4 * t)
    return key.reshape(*lead, rows, k1, 4, t).movedim(-4, -1).contiguous()


def from_kmajor(key: torch.Tensor) -> torch.Tensor:
    """The inverse of `to_kmajor`: int8[..., K, 4, T, rows] ->
    int8[..., rows, K*4*T], contiguous."""
    *lead, k1, four, t, rows = key.shape
    return key.movedim(-1, -4).reshape(*lead, rows, k1 * four * t) \
        .contiguous()


def relayout_kmajor_(key: torch.Tensor, t: int = 128) -> torch.Tensor:
    """Relay a whole key int8[n, rows, K*4*T] K-major in its own storage,
    one step at a time (a step's copy is the only temporary). Returns the
    view int8[n, K, 4, T, rows] of that storage; `key` itself must not be
    read in the reference layout afterwards."""
    n, rows, cols = key.shape
    k1 = cols // (4 * t)
    flat = key.view(n, rows * cols)
    for s in range(n):
        flat[s].copy_(to_kmajor(key[s], t).view(-1))
    return key.view(n, k1, 4, t, rows)


def require_kmajor(who: str, key: torch.Tensor, lead: tuple, k1: int, t: int,
                   rows: int):
    """Raise unless `key` is K-major int8[*lead, k1, 4, t, rows]; name the
    reference layout when that is what came."""
    want = (*lead, k1, 4, t, rows)
    if tuple(key.shape) == want:
        return
    ref = (*lead, rows, k1 * 4 * t)
    if tuple(key.shape) == ref:
        raise ValueError(
            f"{who}: the key is in the reference layout {ref}; the kernel "
            f"reads the K-major layout {want} (ops/dots.py:to_kmajor, done "
            "once when a key reaches the card)")
    raise ValueError(f"{who}: key shape {tuple(key.shape)} does not fit the "
                     f"plan: expected the K-major {want}")


# --- the tables ---


@dataclasses.dataclass(frozen=True)
class DotsTables:
    """A lowering as the kernel's rows. products[i] = (a_off, b_off,
    npieces, chunks, shift, first target, end target, 0): the sum over
    pieces j < npieces of digit bytes [a_off + j*a_stride, + chunks*128)
    . key rows [b_off + j*b_stride, + chunks*128), times 2^shift, added
    with each target's sign into its output block. targets[j] = (posm,
    sign). columns[k] = the (begin, end) products of output column k."""

    products: tuple
    targets: tuple
    columns: tuple
    m: int
    a_stride: int
    b_stride: int

    def slots(self, i: int) -> int:
        """Ring slots of product i: its contraction in 128-byte chunks."""
        return self.products[i][2] * self.products[i][3]


def _rows(entries):
    """(a_off, b_off, npieces, chunks, shift, targets) -> (products,
    targets)."""
    products, targets = [], []
    for a_off, b_off, npieces, chunks, shift, tgts in entries:
        products.append((a_off, b_off, npieces, chunks, shift, len(targets),
                         len(targets) + len(tgts), 0))
        targets.extend(tgts)
    return tuple(products), tuple(targets)


def encode_single_key(products, k1: int, m: int, pt: int) -> DotsTables:
    """`blind_rotate.product_tables` (or the dense one): (lhs_seg, e_seg,
    nseg, shift, targets) with segments of P*T bytes; every product serves
    every output poly."""
    if pt % CHUNK:
        raise ValueError(f"P*T = {pt} is not a multiple of {CHUNK}")
    rows, targets = _rows((lseg * pt, eseg * pt, 1, nseg * pt // CHUNK,
                           shift, tgts)
                          for lseg, eseg, nseg, shift, tgts in products)
    return DotsTables(rows, targets, ((0, len(rows)),) * k1, m, 0, 0)


def encode_multi_key(products, k1: int, m: int, pt: int, lt: int,
                     nzn: int) -> DotsTables:
    """`mk_cmux.mk_product_tables`: (k_col, lhs_off, e_row, nseg, shift,
    targets), sorted by k_col; nseg pieces of l*T bytes, strided by P*T in
    the digits and NZ*l*T in the operand."""
    if lt % CHUNK:
        raise ValueError(f"l*T = {lt} is not a multiple of {CHUNK}")
    rows, targets = _rows((lhs_off, e_row, nseg, lt // CHUNK, shift, tgts)
                          for _, lhs_off, e_row, nseg, shift, tgts in products)
    cols = [pr[0] for pr in products]
    if cols != sorted(cols):
        raise ValueError("multi-key products are not sorted by column")
    columns = tuple((cols.index(k) if k in cols else 0,
                     len(cols) - cols[::-1].index(k) if k in cols else 0)
                    for k in range(k1))
    return DotsTables(rows, targets, columns, m, pt, nzn * lt)


# --- launch geometry ---


def slot_bytes(row_tile: int = ROW_TILE) -> int:
    """A ring slot: the digit tile of the block's rows and one key tile."""
    return (row_tile + 4 * COL_TILE) * CHUNK


def ring_stages(m: int, row_tile: int = ROW_TILE) -> int:
    """Ring slots for the M output blocks' sums of each warpgroup beside the
    ring: as many as let two blocks share an SM (3 to 6), else as many as
    one block may use."""
    sums = m * SUMS_BYTES * (row_tile // ROW_TILE)
    for budget in (_SM_SMEM // 2 - _RESERVED, _BLOCK_SMEM):
        stages = min(6, (budget - sums - 2 * 6 * 8) // slot_bytes(row_tile))
        if stages >= 3:
            return stages
    raise ValueError(f"M = {m} output blocks' sums ({sums} bytes) leave no "
                     f"room for a 3-slot ring in {_BLOCK_SMEM} bytes of "
                     f"shared memory at {row_tile} rows a block")


def smem_bytes(m: int, stages: int, row_tile: int = ROW_TILE) -> int:
    """A dots block's dynamic shared memory (csrc: dots_smem_bytes)."""
    return (stages * slot_bytes(row_tile)
            + m * SUMS_BYTES * (row_tile // ROW_TILE) + 2 * stages * 8)


def blocks_per_sm(m: int) -> int:
    """64-row dots blocks one SM holds at once at M output blocks (1 or 2):
    as many as its shared memory fits at `ring_stages(m)` slots."""
    return max(1, min(2, _SM_SMEM // (smem_bytes(m, ring_stages(m))
                                      + _RESERVED)))


def row_tile(m: int, batch: int) -> int:
    """The batch rows a dots block owns at M output blocks: 128 (two
    consumer warpgroups on each key tile) where the 64-row block is alone
    on its SM anyway, two warpgroups' sums fit beside a ring of 3 slots or
    more (M <= 8), and the batch has more than one 64-row tile; else 64."""
    if batch <= ROW_TILE or blocks_per_sm(m) != 1:
        return ROW_TILE
    try:
        ring_stages(m, WIDE_ROW_TILE)
    except ValueError:
        return ROW_TILE
    return WIDE_ROW_TILE


def work_items(tables: DotsTables, tiles: int, target_blocks: int) -> tuple:
    """The blocks' work: (k*4 + wt, begin, end, atomic) rows, heaviest
    first. A column's product list is cut into ranges of about equal slots
    where the whole grid would otherwise have fewer than `target_blocks`
    blocks' worth of work per block, or where a column is heavier than that
    share; a cut column's ranges add into acc with atomics."""
    slots = [tables.slots(i) for i in range(len(tables.products))]
    work = [sum(slots[b:e]) for b, e in tables.columns]
    total = sum(work) * 4 * tiles
    budget = max(math.ceil(total / max(target_blocks, 1)), max(slots),
                 _MIN_SLOTS)
    items = []
    for k, (b, e) in enumerate(tables.columns):
        if b == e:
            continue
        n_cut = max(1, min(e - b, math.ceil(work[k] / budget)))
        share = work[k] / n_cut
        ranges, start, done = [], b, 0
        for i in range(b, e):
            done += slots[i]
            if len(ranges) < n_cut - 1 and done >= share * (len(ranges) + 1) \
                    and i + 1 < e:
                ranges.append((start, i + 1))
                start = i + 1
        ranges.append((start, e))
        for lo, hi in ranges:
            for wt in range(4):
                items.append((sum(slots[lo:hi]),
                              (k * 4 + wt, lo, hi, int(len(ranges) > 1))))
    items.sort(key=lambda it: -it[0])  # stable: plan order among equals
    return tuple(item for _, item in items)


def launch_order(tables: DotsTables, items: tuple, tiles: int,
                 cluster: int) -> tuple:
    """The blocks' units in launch order, one row (k*4 + wt, begin, end,
    atomic, batch tile) a block: the heaviest items first over all batch
    tiles, so that the grid's last blocks are its lightest and no heavy
    block starts at the end; then by batch tile, the `cluster` tiles of a
    cluster side by side, then by item. Items of one weight keep the order
    of a grid of items by tiles."""
    weight = [sum(tables.slots(i) for i in range(lo, hi))
              for _, lo, hi, _ in items]
    units = sorted((-weight[i], t // cluster, i, t % cluster)
                   for i in range(len(items)) for t in range(tiles))
    return tuple((*items[i], g * cluster + r) for _, g, i, r in units)


def cluster_size(tiles: int) -> int:
    """Blocks of a thread-block cluster along the batch tile, which run
    one work item together: 2 where the batch tiles pair up, else 1 (a
    plain launch). It divides `tiles`."""
    return 2 if tiles % 2 == 0 else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(torch.device(device)) \
        .multi_processor_count


def int_table(rows, device) -> torch.Tensor:
    """A list of int rows as one flat int32 tensor on `device`."""
    flat = [v for row in rows for v in row] or [0]
    return torch.tensor(flat, dtype=torch.int32, device=device)


@cached_build("device_rows")
def _device_rows(tables: DotsTables, device: str):
    return int_table(tables.products, device), \
        int_table(tables.targets, device)


@cached_build("device_items")
def _device_items(tables: DotsTables, tiles: int, target_blocks: int,
                  cluster: int, device: str):
    units = launch_order(tables, work_items(tables, tiles, target_blocks),
                         tiles, cluster)
    return int_table(units, device), len(units)


class DotsArgs(ctypes.Structure):
    """The dots tables of a C entry's launches (csrc/dots_sm90.cuh:
    DotsArgs): the product and target rows and the blocks' units in launch
    order (`launch_order`, n_items rows) on the device, the ring's slots,
    the blocks of a cluster along the batch tile, and the batch rows of a
    block (`row_tile`). The device rows are held by the caches of this
    module."""

    _fields_ = [("products", ctypes.c_void_p), ("targets", ctypes.c_void_p),
                ("items", ctypes.c_void_p), ("n_items", ctypes.c_int),
                ("stages", ctypes.c_int), ("cluster", ctypes.c_int),
                ("row_tile", ctypes.c_int)]


def dots_args(tables: DotsTables, batch: int, device: torch.device,
              calls: int = 1) -> DotsArgs:
    """What every C entry takes for its dots launches, the tables on
    `device`, for `calls` C calls at this batch; counts the clustered calls
    in `dots.clustered`, and every call in `dots.per_sm.<r>` by the 64-row
    blocks an SM holds and in `dots.row_tile.<r>` by the rows of its tile.
    The work items are cut for two waves of 64-row warpgroups: a 128-row
    block counts as two."""
    dev = str(device)
    per_sm = blocks_per_sm(tables.m)
    rows = row_tile(tables.m, batch)
    count(f"dots.per_sm.{per_sm}", calls)
    count(f"dots.row_tile.{rows}", calls)
    tiles = -(-batch // rows)
    cluster = cluster_size(tiles)
    if cluster > 1:
        count("dots.clustered", calls)
    products, targets = _device_rows(tables, dev)
    target = _WAVES * per_sm * _sm_count(dev) * ROW_TILE // rows
    units, n_units = _device_items(tables, tiles, target, cluster, dev)
    return DotsArgs(products.data_ptr(), targets.data_ptr(), units.data_ptr(),
                    n_units, ring_stages(tables.m, rows), cluster, rows)
