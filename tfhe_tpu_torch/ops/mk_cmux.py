"""The multi-key CMUX over the sparse block structure: plain torch
versions, CUDA kernel wrappers, and the dispatchers between them.

Counterpart of the multi-key part of `tfhe_tpu/ops/pallas_cmux.py`:
`cmux_step_pallas_sparse` (one step), `mk_blind_rotate_pallas_chunk` (a
chunk of steps against pre-expanded operands) and
`mk_blind_rotate_pallas_compact` (a party's whole loop from its compact
limbs, the expansion inside), under the plan lowering `_sparse_plan`.

A party's expanded operand has only NZ nonzero (block row j, output column
k) blocks (`mk.internals.mk_nonzero_blocks`). A step's operand is their
sparse expansion `karatsuba.expand_karatsuba_sparse`: int8[R*NZ*l*T, 4*T],
rows (bake row r, block z, l', u), columns (limb, w). Block z alone is a
Karatsuba-baked key with P = l rows and one output polynomial, so the plain
step is `karatsuba_delta` of digit polynomial j against block z, added into
accumulator column k.

* `sparse_plan`: the reference's static unit metadata, as it is.
* `mk_kernel_tables`: the same plan as terms, one per (product, output
  block); `mk_product_tables`: each distinct product once with the output
  blocks it feeds, the table the CUDA dots kernel reads.
* `cmux_step_sparse_plain`, `mk_blind_rotate_chunk_plain`,
  `mk_blind_rotate_compact_plain`: torch ops. The CPU path and the oracle
  for the kernels.
* `cmux_step_sparse_kernel`, `mk_blind_rotate_chunk_kernel`,
  `mk_blind_rotate_compact_kernel`: the CUDA wrappers (`csrc/mk_cmux.cu`);
  each counts the C calls that launched its kernels (`instrument` counters
  named as in `ops.kernel_wrappers()`). The
  step and chunk wrappers take the operand K-major (`dots.to_kmajor`'s
  layout, as `expand_sparse` writes it on the card) and raise on the
  reference layout.
* `expand_sparse`: one step's expansion; CUDA tensors go through the
  expansion kernel of `ops/compact.py` (a step's nonzero blocks are a
  compact key step with P = NZ*l rows and K = 1), K-major.
* `cmux_step_sparse`, `mk_blind_rotate_chunk`, `mk_blind_rotate_compact`:
  CPU tensors take the plain version; CUDA tensors launch the kernel or
  raise.
"""

from __future__ import annotations

import torch

from ..instrument import cached_build, count, span
from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from . import dots
from .blind_rotate import (
    kernel_plan,
    raise_on_error,
    require,
    rotation_launch,
)
from .compact import _device_entry_masks, expand_step_kernel
from .karatsuba import (
    KaratsubaPlan,
    expand_karatsuba_sparse,
    karatsuba_delta,
    select_nz_limbs,
)


def sparse_plan(plan: KaratsubaPlan, l: int, p: int, t: int, nz,
                inline_combos: bool = True):
    """Static metadata of the sparse-block multi-key step, exactly as the
    reference's `_sparse_plan`: (combo_writes, units, comb_rows).

    One unit per (leaf, nonzero (j, k) block): (e_tiles, k_col, outs).
    `e_tiles` are the operand row offsets of the leaf's L entry tiles (each
    [l*T, 4T]); `outs` give, per linear-convolution output o, the products
    ((entry slot a, digit descriptors), ...) and the folded positions
    ((posm, sign), ...) in output column k. A digit descriptor is
    (buffer, byte offset of the j-slice, shift): buffer 0 the raw digit
    blocks, 1 the combo rows, 2 (only with `inline_combos`, the reference's
    TPU lowering) a tuple of raw offsets to sum. The CUDA tables are built
    from the lowering without inline combos.
    """
    combo_writes, leaf_dots, comb_rows = kernel_plan(plan, p, t,
                                                     inline_combos)
    lt, pt, m, nzn = l * t, p * t, plan.m, len(nz)
    units = []
    for e_row, L, lhs_descs, contribs in leaf_dots:
        for zi, (j, k_col) in enumerate(nz):
            e_tiles = tuple(((e_row + a) * nzn + zi) * lt for a in range(L))
            outs = []
            for o in range(2 * L - 1):
                i0, i1 = max(0, o - L + 1), min(L - 1, o)
                ops = []
                for i in range(i0, i1 + 1):
                    a = L - 1 - o + i  # packed (reversed) entry slot
                    descs = []
                    for desc in lhs_descs:
                        if desc[0] == 2:
                            descs.append((2, tuple(
                                blk * pt + j * lt for blk in desc[1][i]), 0))
                        else:
                            buf, row0, sh = desc
                            descs.append((buf, (row0 + i) * pt + j * lt, sh))
                    ops.append((a, tuple(descs)))
                placed = []
                for off, sgn in contribs:
                    pos = off + o
                    if pos >= 2 * m - 1:
                        continue
                    placed.append((pos % m, sgn if pos < m else -sgn))
                outs.append((tuple(ops), tuple(placed)))
            units.append((e_tiles, k_col, tuple(outs)))
    return combo_writes, tuple(units), comb_rows


def mk_kernel_tables(plan: KaratsubaPlan, l: int, k1: int, t: int, nz):
    """The sparse plan's terms, one per (product, output block): the form
    `mk_product_tables` groups by product, and its check (the tests hold
    the two equal as multisets).

    The digit operand is the single-key one (`blind_rotate.kernel_tables`):
    per ciphertext `lhs_rows` segments of P*T bytes (P = k1*l), raw digit
    blocks first, then the combo rows. Returns (terms, term_start):

    * terms[i] = (group, lhs_off, e_row, nseg, shift, sign): output block
      group = k*M + posm gets sign * 2^shift * sum over pieces i < nseg of
      digit bytes [lhs_off + i*P*T, + l*T) . operand rows
      [e_row + i*NZ*l*T, + l*T), all mod 2^32. Sorted by group.
    * term_start: k1*M + 1 offsets of each group's terms.
    """
    m, p = plan.m, k1 * l
    pt, lt, nzn = p * t, l * t, len(nz)
    _, units, _ = sparse_plan(plan, l, p, t, nz, inline_combos=False)
    terms = []
    for e_tiles, k_col, outs in units:
        for ops, placed in outs:
            a0, descs0 = ops[0]
            for d, (buf, lrow0, shift) in enumerate(descs0):
                for i, (a, descs) in enumerate(ops):
                    # pieces advance by one digit segment and one entry tile
                    if (a != a0 + i or descs[d][1] != lrow0 + i * pt
                            or e_tiles[a] != e_tiles[a0] + i * nzn * lt):
                        raise ValueError("unit pieces are not evenly strided")
                lhs_off = (m * pt if buf else 0) + lrow0
                for posm, sgn in placed:
                    terms.append((k_col * m + posm, lhs_off, e_tiles[a0],
                                  len(ops), shift, sgn))
    terms.sort(key=lambda tm: tm[0])  # stable: plan order within a group
    term_start = [0] * (k1 * m + 1)
    for tm in terms:
        term_start[tm[0] + 1] += 1
    for g in range(k1 * m):
        term_start[g + 1] += term_start[g]
    return terms, term_start


def mk_product_tables(plan: KaratsubaPlan, l: int, k1: int, t: int,
                      nz) -> tuple:
    """`mk_kernel_tables`' terms with each distinct product once: one entry
    (k_col, lhs_off, e_row, nseg, shift, targets) per (unit, convolution
    output, digit limb), sorted by k_col (stable), targets = ((posm,
    sign), ...) the blocks of column k_col it feeds. Expanded over its
    targets (group = k_col*M + posm), it gives back exactly
    `mk_kernel_tables`' terms as a multiset."""
    m, p = plan.m, k1 * l
    pt, lt, nzn = p * t, l * t, len(nz)
    _, units, _ = sparse_plan(plan, l, p, t, nz, inline_combos=False)
    products = []
    for e_tiles, k_col, outs in units:
        for ops, placed in outs:
            if len({posm for posm, _ in placed}) != len(placed):
                raise ValueError("two contributions fold onto one block")
            if not placed:
                continue
            a0, descs0 = ops[0]
            for d, (buf, lrow0, shift) in enumerate(descs0):
                for i, (a, descs) in enumerate(ops):
                    # pieces advance by one digit segment and one entry tile
                    if (a != a0 + i or descs[d][1] != lrow0 + i * pt
                            or e_tiles[a] != e_tiles[a0] + i * nzn * lt):
                        raise ValueError("unit pieces are not evenly strided")
                products.append((k_col, (m * pt if buf else 0) + lrow0,
                                 e_tiles[a0], len(ops), shift, tuple(placed)))
    products.sort(key=lambda pr: pr[0])
    return tuple(products)


@cached_build("mk_dots_tables")
def _mk_dots_tables(plan: KaratsubaPlan, l: int, k1: int, t: int,
                    nz) -> dots.DotsTables:
    return dots.encode_multi_key(mk_product_tables(plan, l, k1, t, nz), k1,
                                 plan.m, k1 * l * t, l * t, len(nz))


def e_step_rows(plan: KaratsubaPlan, l: int, t: int, nz) -> int:
    """Rows of one step's sparse expansion."""
    return plan.total_rows * len(nz) * l * t


# --- plain versions ---


def cmux_step_sparse_plain(acc: torch.Tensor, e_step: torch.Tensor,
                           bara: torch.Tensor, *, l: int, b: int, t: int,
                           plan: KaratsubaPlan, nz,
                           balanced: bool) -> torch.Tensor:
    """One multi-key CMUX step in torch ops: acc int32[B, K, N]; e_step
    int8[R*NZ*l*T, 4*T]; bara int32[B]; nz the ((j, k), ...) blocks in the
    accumulator's own indices. Returns int32[B, K, N]."""
    digits = decompose(mul_by_monomial(acc, bara[:, None]) - acc, l, b,
                       balanced)  # [B, K, l, N]
    blocks = e_step.reshape(plan.total_rows, len(nz), l * t, 4 * t)
    out = acc.clone()
    for zi, (j, k_col) in enumerate(nz):
        e_block = blocks[:, zi].reshape(plan.total_rows * l * t, 4 * t)
        out[:, k_col] += karatsuba_delta(digits[:, j], e_block, t, plan)[:, 0]
    return out


def mk_blind_rotate_chunk_plain(acc: torch.Tensor, e_chunk: torch.Tensor,
                                bara_t: torch.Tensor, *, l: int, b: int,
                                t: int, plan: KaratsubaPlan, nz,
                                balanced: bool) -> torch.Tensor:
    """S steps against e_chunk int8[S, R*NZ*l*T, 4*T], bara_t int32[S, B]:
    the loop of the step's plain version."""
    for s in range(e_chunk.shape[0]):
        acc = cmux_step_sparse_plain(acc, e_chunk[s], bara_t[s], l=l, b=b,
                                     t=t, plan=plan, nz=nz, balanced=balanced)
    return acc


def mk_blind_rotate_compact_plain(acc: torch.Tensor, limbs: torch.Tensor,
                                  bara_t: torch.Tensor, *, l: int, b: int,
                                  t: int, plan: KaratsubaPlan, nz,
                                  balanced: bool) -> torch.Tensor:
    """A party's steps from its nz-selected compact limbs
    int8[n, 4, NZ, l, 2N]: per step the plain expansion, then the plain
    step."""
    for s in range(limbs.shape[0]):
        e_step = expand_karatsuba_sparse(limbs[s], t, plan, nz, l,
                                         preselected=True)
        acc = cmux_step_sparse_plain(acc, e_step, bara_t[s], l=l, b=b, t=t,
                                     plan=plan, nz=nz, balanced=balanced)
    return acc


# --- kernel wrappers ---


def _check_nz(who: str, nz, k1: int):
    require(len(nz) > 0 and all(0 <= j < k1 and 0 <= k < k1 for j, k in nz),
            f"nonzero blocks {nz} do not fit {k1} components", who)


def _mk_launch(who: str, acc, key, bara_t, l, b, t, plan, nz, balanced):
    """`rotation_launch` for the multi-key entries, then the blocks' own
    check; returns (the launch, NZ)."""
    nz = tuple(tuple(pair) for pair in nz)
    run = rotation_launch(
        who, acc, key, bara_t, l=l, b=b, t=t,
        offset=decomp_offset(l, b, balanced), plan=plan,
        tables=lambda: _mk_dots_tables(plan, l, acc.shape[1], t, nz))
    _check_nz(who, nz, run.sizes.k1)
    return run, len(nz)


def cmux_step_sparse_kernel(acc: torch.Tensor, e_step: torch.Tensor,
                            bara: torch.Tensor, *, l: int, b: int, t: int,
                            plan: KaratsubaPlan, nz,
                            balanced: bool) -> torch.Tensor:
    """One multi-key CMUX step through the CUDA kernels; the contract of
    `cmux_step_sparse_plain` with the operand K-major, int8[1, 4, T,
    R*NZ*l*T], as `expand_sparse` gives it on the card (raises on the
    reference layout). Takes T = 128 only. Launches on the current stream
    and does not synchronise."""
    who = "cmux_step_sparse_kernel"
    run, nzn = _mk_launch(who, acc, e_step[None], bara[None], l, b, t, plan,
                          nz, balanced)
    dots.require_kmajor(who, e_step, (), 1, t, e_step_rows(plan, l, t, nz))
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_mk_cmux_step(
                run.out.data_ptr(), e_step.data_ptr(), bara.data_ptr(),
                run.lhs.data_ptr(), run.sizes, run.dots, nzn, run.stream)
        raise_on_error(who, run.lib, err)
        count("cmux_step_sparse")
        count("rotate_decompose_rows")
    return run.out


def mk_blind_rotate_chunk_kernel(acc: torch.Tensor, e_chunk: torch.Tensor,
                                 bara_t: torch.Tensor, *, l: int, b: int,
                                 t: int, plan: KaratsubaPlan, nz,
                                 balanced: bool) -> torch.Tensor:
    """A chunk of steps in one C call; the contract of
    `mk_blind_rotate_chunk_plain` with the operands K-major, int8[S, 1, 4,
    T, R*NZ*l*T] (`expand_sparse`'s steps on the card, stacked; raises on
    the reference layout)."""
    who = "mk_blind_rotate_chunk_kernel"
    run, nzn = _mk_launch(who, acc, e_chunk, bara_t, l, b, t, plan, nz,
                          balanced)
    n_steps = e_chunk.shape[0]
    dots.require_kmajor(who, e_chunk, (n_steps,), 1, t,
                        e_step_rows(plan, l, t, nz))
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_mk_blind_rotate_chunk(
                run.out.data_ptr(), e_chunk.data_ptr(), bara_t.data_ptr(),
                run.lhs.data_ptr(), run.sizes, run.dots, n_steps, nzn,
                run.stream)
        raise_on_error(who, run.lib, err)
        count("mk_blind_rotate_chunk")
        count("rotate_decompose_rows", n_steps)
    return run.out


def mk_blind_rotate_compact_kernel(acc: torch.Tensor, limbs: torch.Tensor,
                                   bara_t: torch.Tensor, *, l: int, b: int,
                                   t: int, plan: KaratsubaPlan, nz,
                                   balanced: bool) -> torch.Tensor:
    """A party's whole loop from its compact limbs in one C call (3 CUDA
    launches per step); the same contract as
    `mk_blind_rotate_compact_plain`."""
    who = "mk_blind_rotate_compact_kernel"
    run, nzn = _mk_launch(who, acc, limbs, bara_t, l, b, t, plan, nz,
                          balanced)
    n_steps, n = limbs.shape[0], run.sizes.n
    require(tuple(limbs.shape) == (n_steps, 4, nzn, l, 2 * n),
            f"compact limbs {tuple(limbs.shape)}, expected "
            f"(n, 4, {nzn}, {l}, {2 * n})", who)
    masks = _device_entry_masks(plan, str(acc.device))
    scratch = torch.empty((4, t, e_step_rows(plan, l, t, nz)),
                          dtype=torch.int8, device=acc.device)  # K-major
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_mk_blind_rotate_compact(
                run.out.data_ptr(), limbs.data_ptr(), bara_t.data_ptr(),
                run.lhs.data_ptr(), scratch.data_ptr(), masks.data_ptr(),
                run.sizes, run.dots, n_steps, nzn, run.stream)
        raise_on_error(who, run.lib, err)
        count("mk_blind_rotate_compact")
        count("expand_karatsuba_step")  # the loop runs that kernel too
        count("rotate_decompose_rows", n_steps)
    return run.out


# --- dispatchers ---


def expand_sparse(limbs_step: torch.Tensor, *, t: int, plan: KaratsubaPlan,
                  nz, l: int, preselected: bool) -> torch.Tensor:
    """One step's sparse expansion. CPU tensors take
    `expand_karatsuba_sparse` (the reference layout int8[R*NZ*l*T, 4*T]);
    CUDA tensors the expansion kernel, on the selected blocks viewed as a
    compact step of NZ*l rows and one column, written K-major,
    int8[1, 4, T, R*NZ*l*T]: the layout the step and chunk kernels read."""
    if not limbs_step.is_cuda:
        return expand_karatsuba_sparse(limbs_step, t, plan, nz, l,
                                       preselected)
    sel = limbs_step if preselected else select_nz_limbs(limbs_step, nz, l)
    require(tuple(sel.shape[:3]) == (4, len(nz), l),
            f"limbs {tuple(sel.shape)} do not hold {len(nz)} blocks of {l} "
            "rows", "expand_sparse")
    return expand_step_kernel(
        sel.contiguous().reshape(4, len(nz) * l, 1, sel.shape[-1]), t=t,
        plan=plan, kmajor=True)


def cmux_step_sparse(acc, e_step, bara, **kw) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = cmux_step_sparse_kernel if acc.is_cuda else cmux_step_sparse_plain
    return fn(acc, e_step, bara, **kw)


def mk_blind_rotate_chunk(acc, e_chunk, bara_t, **kw) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = (mk_blind_rotate_chunk_kernel if acc.is_cuda
          else mk_blind_rotate_chunk_plain)
    return fn(acc, e_chunk, bara_t, **kw)


def mk_blind_rotate_compact(acc, limbs, bara_t, **kw) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = (mk_blind_rotate_compact_kernel if acc.is_cuda
          else mk_blind_rotate_compact_plain)
    return fn(acc, limbs, bara_t, **kw)
