"""One fused block-Karatsuba CMUX step: plain torch version, CUDA kernel
wrapper, and the dispatcher between them.

Counterpart of `cmux_step_pallas_karatsuba` of `tfhe_tpu/ops/pallas_cmux.py`
(kernel `_fused_karatsuba_kernel`): acc + e_step (x) [(X^bara - 1) * acc]
for one step of a Karatsuba-baked key, in one kernel launch. No path of the
package runs it (the bootstrap goes through the whole-rotation kernels); it
is an entry point of its own for callers that hold one step's key slice, as
in the reference.

* `cmux_step_karatsuba_plain`: `blind_rotate.mux_rotate_karatsuba` under the
  reference entry's argument order, the step in the reference layout
  int8[R*P*T, K*4*T]. The CPU path and the kernel's oracle.
* `cmux_step_karatsuba_kernel`: the CUDA wrapper (`csrc/fused_step.cu`),
  the step K-major int8[K, 4, T, R*P*T] (`key[s]` of a baked key on the
  card, `dots.to_kmajor` of a reference step); it raises on the reference
  layout and never converts. It counts its launches (`instrument` counter
  "cmux_step_karatsuba").
* `cmux_step_karatsuba`: CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise.

The kernel runs a persistent grid of as many blocks as the card holds at
once: each block first forms the digit rows of its groups of 16 rows (the
rotate/decompose front half), then runs its (batch tile, column tile)
units of the dots, each unit waiting until its tile's rows are formed
(`fused_tables`, `block_groups` and `block_units` say who does what; a CPU
test emulates it).
"""

from __future__ import annotations

import torch

from ..instrument import cached_build, count, span
from ..tgsw import decomp_offset
from . import dots
from .blind_rotate import (
    dots_tables,
    kernel_tables,
    mux_rotate_karatsuba,
    raise_on_error,
    rotation_launch,
)
from .karatsuba import KaratsubaPlan

GROUP_ROWS = 16  # rows a block forms at once: a quarter of a batch tile


def fused_tables(plan: KaratsubaPlan, k1: int, l: int, t: int):
    """The fused kernel's tables: (combos, lhs_rows, tables, items).

    * combos, lhs_rows: the digit rows the blocks form, as `kernel_tables`
      gives them (`combo_table` packs them for the launch).
    * tables: the dots' products, each distinct one once with its targets
      (`blind_rotate.dots_tables`).
    * items: one row (k*4 + wt, 0, n_products, 0) per column tile (poly k,
      32 coefficients wt*32 .. wt*32 + 31, all four limbs), K*4 of them;
      a unit is one column tile of one 64-row batch tile, over every
      product (`block_units`).
    """
    combos, _, _, lhs_rows = kernel_tables(plan, k1 * l, t)
    tables = dots_tables(plan, k1, l, t)
    n_products = len(tables.products)
    items = tuple((col, 0, n_products, 0) for col in range(k1 * 4))
    return combos, lhs_rows, tables, items


def grid_blocks(batch: int, n_cols: int, resident: int) -> int:
    """The launch's blocks (csrc: FusedStep::run): as many as phase 1's
    groups or phase 2's units need, at most the `resident` blocks the card
    holds at once."""
    tiles = -(-batch // dots.ROW_TILE)
    return min(max(tiles * n_cols, -(-batch // GROUP_ROWS)), resident)


def block_groups(batch: int, blocks: int, block: int) -> list:
    """The rows whose digit rows block `block` of `blocks` forms, group by
    group: groups block, block + blocks, ... of GROUP_ROWS rows; rows past
    the batch are not formed (TMA reads them as zeros)."""
    n_groups = -(-batch // GROUP_ROWS)
    return [range(g * GROUP_ROWS, min((g + 1) * GROUP_ROWS, batch))
            for g in range(block, n_groups, blocks)]


def block_units(batch: int, n_cols: int, blocks: int, block: int) -> list:
    """The units block `block` of `blocks` runs, in order: (batch tile,
    column) for units block, block + blocks, ... of tiles x n_cols, the
    column fastest."""
    total = -(-batch // dots.ROW_TILE) * n_cols
    return [divmod(u, n_cols) for u in range(block, total, blocks)]


def stage_rows(k1: int, n: int, m: int) -> int:
    """The accumulator rows phase 1 stages in shared memory at a time: as
    many of a group's rows as fit the dots' shared memory, at least one."""
    room = dots.smem_bytes(m, dots.ring_stages(m))
    return max(1, min(GROUP_ROWS, room // (k1 * n * 4)))


@cached_build("device_tables")
def _device_tables(plan: KaratsubaPlan, k1: int, l: int, t: int,
                   device: str):
    _, _, tables, items = fused_tables(plan, k1, l, t)
    products, targets = dots.int_table(tables.products, device), \
        dots.int_table(tables.targets, device)
    return products, targets, dots.int_table(items, device), len(items)


def cmux_step_karatsuba_plain(acc: torch.Tensor, e_step: torch.Tensor,
                              bara: torch.Tensor, *, l: int, b: int, t: int,
                              plan: KaratsubaPlan,
                              balanced: bool) -> torch.Tensor:
    """One CMUX step in torch ops: acc int32[B, K, N]; e_step
    int8[total_rows*P*T, K*4*T]; bara int32[B]. Returns a new int32[B, K, N]."""
    return mux_rotate_karatsuba(acc, e_step, bara, l, b, t, plan, balanced)


def cmux_step_karatsuba_kernel(acc: torch.Tensor, e_step: torch.Tensor,
                               bara: torch.Tensor, *, l: int, b: int, t: int,
                               plan: KaratsubaPlan,
                               balanced: bool) -> torch.Tensor:
    """`cmux_step_karatsuba_plain` through the fused CUDA kernel, with the
    step K-major: e_step int8[K, 4, T, total_rows*P*T]. One launch on the
    current stream (after a memset of the tiles' counters), no
    synchronisation; `acc` is not modified. Besides the output it allocates
    the digit rows' scratch, B x lhs_rows*P*T bytes (the two-launch
    rotation's `lhs`), which the kernel's blocks write and read back by TMA
    while it is in L2, and one int32 counter per 64-row batch tile."""
    who = "cmux_step_karatsuba_kernel"
    if acc.dim() == 3:  # the layout first: named as such on any device
        k1 = acc.shape[1]
        dots.require_kmajor(who, e_step, (), k1, t,
                            plan.total_rows * k1 * l * t)
    run = rotation_launch(who, acc, e_step[None], bara[None], l=l, b=b, t=t,
                          offset=decomp_offset(l, b, balanced), plan=plan)
    bsz, k1, n, m = (run.sizes.batch, run.sizes.k1, run.sizes.n,
                     run.sizes.m)
    out = torch.empty_like(acc)
    if bsz:
        products, targets, items, n_items = _device_tables(plan, k1, l, t,
                                                           str(acc.device))
        tables = dots.DotsArgs(products.data_ptr(), targets.data_ptr(),
                               items.data_ptr(), n_items,
                               dots.ring_stages(m), 1, dots.ROW_TILE)
        ready = torch.empty((-(-bsz // dots.ROW_TILE),), dtype=torch.int32,
                            device=acc.device)
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_cmux_step_karatsuba(
                acc.data_ptr(), e_step.data_ptr(), bara.data_ptr(),
                out.data_ptr(), run.lhs.data_ptr(), ready.data_ptr(),
                run.sizes, tables, stage_rows(k1, n, m), run.stream)
        raise_on_error(who, run.lib, err)
        count("cmux_step_karatsuba")
    return out


def cmux_step_karatsuba(acc: torch.Tensor, e_step: torch.Tensor,
                        bara: torch.Tensor, *, l: int, b: int, t: int,
                        plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version (the step in the reference
    layout), CUDA tensors the kernel (the step K-major)."""
    fn = cmux_step_karatsuba_kernel if acc.is_cuda \
        else cmux_step_karatsuba_plain
    return fn(acc, e_step, bara, l=l, b=b, t=t, plan=plan, balanced=balanced)
