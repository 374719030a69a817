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
* `mk_kernel_tables`: the same plan as the int tables the CUDA kernel reads.
* `cmux_step_sparse_plain`, `mk_blind_rotate_chunk_plain`,
  `mk_blind_rotate_compact_plain`: torch ops. The CPU path and the oracle
  for the kernels.
* `cmux_step_sparse_kernel`, `mk_blind_rotate_chunk_kernel`,
  `mk_blind_rotate_compact_kernel`: the CUDA wrappers (`csrc/mk_cmux.cu`);
  each counts the C calls that launched its kernels in `.launches`.
* `expand_sparse`: one step's expansion; CUDA tensors go through the
  expansion kernel of `ops/compact.py` (a step's nonzero blocks are a
  compact key step with P = NZ*l rows and K = 1).
* `cmux_step_sparse`, `mk_blind_rotate_chunk`, `mk_blind_rotate_compact`:
  CPU tensors take the plain version; CUDA tensors launch the kernel or
  raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from .blind_rotate import (
    check_rotation_args,
    device_tables,
    int_table,
    kernel_plan,
    raise_on_error,
    require,
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
    """The sparse plan as the unit-dots kernel's int tables.

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


@functools.lru_cache(maxsize=None)
def _device_mk_tables(plan: KaratsubaPlan, l: int, k1: int, t: int, nz,
                      device: str):
    terms, term_start = mk_kernel_tables(plan, l, k1, t, nz)
    return int_table(terms, device), int_table([term_start], device)


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


def _mk_call(who: str, acc, key, bara_t, l, b, t, plan, nz, balanced):
    """Checks shared by the three wrappers; returns what every C entry
    takes: (lib, out, lhs, sizes, tables, stream)."""
    from . import _build

    bsz, k1, n, m, pt = check_rotation_args(who, acc, key, bara_t, l, b, t,
                                            plan)
    nz = tuple(tuple(pair) for pair in nz)
    _check_nz(who, nz, k1)
    lib = _build.load()
    device = str(acc.device)
    combos, n_combos, _, _, lhs_rows = device_tables(plan, k1 * l, t, device)
    terms, term_start = _device_mk_tables(plan, l, k1, t, nz, device)
    out = acc.clone()
    lhs = torch.empty((bsz, lhs_rows * pt), dtype=torch.int8,
                      device=acc.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(acc.device).cuda_stream)
    tables = (combos.data_ptr(), n_combos, terms.data_ptr(),
              term_start.data_ptr())
    sizes = dict(bsz=bsz, k1=k1, n=n, m=m, lhs_rows=lhs_rows, nzn=len(nz),
                 offset=decomp_offset(l, b, balanced))
    return lib, out, lhs, sizes, tables, stream


def cmux_step_sparse_kernel(acc: torch.Tensor, e_step: torch.Tensor,
                            bara: torch.Tensor, *, l: int, b: int, t: int,
                            plan: KaratsubaPlan, nz,
                            balanced: bool) -> torch.Tensor:
    """One multi-key CMUX step through the CUDA kernels; the same contract
    as `cmux_step_sparse_plain`. Takes T = 128 only. Launches on the
    current stream and does not synchronise."""
    who = "cmux_step_sparse_kernel"
    require(e_step.dim() == 2 and bara.dim() == 1,
            "e_step must be [rows, 4T], bara [B]", who)
    lib, out, lhs, sz, tables, stream = _mk_call(
        who, acc, e_step[None], bara[None], l, b, t, plan, nz, balanced)
    require(tuple(e_step.shape) == (e_step_rows(plan, l, t, nz), 4 * t),
            f"operand shape {tuple(e_step.shape)} does not fit the plan", who)
    if sz["bsz"]:
        err = lib.tfhe_mk_cmux_step(
            out.data_ptr(), e_step.data_ptr(), bara.data_ptr(),
            lhs.data_ptr(), *tables, sz["bsz"], sz["k1"], sz["n"], l, b,
            sz["m"], sz["lhs_rows"], sz["nzn"], sz["offset"], stream)
        raise_on_error(who, lib, err)
        cmux_step_sparse_kernel.launches += 1
    return out


cmux_step_sparse_kernel.launches = 0


def mk_blind_rotate_chunk_kernel(acc: torch.Tensor, e_chunk: torch.Tensor,
                                 bara_t: torch.Tensor, *, l: int, b: int,
                                 t: int, plan: KaratsubaPlan, nz,
                                 balanced: bool) -> torch.Tensor:
    """A chunk of steps in one C call; the same contract as
    `mk_blind_rotate_chunk_plain`."""
    who = "mk_blind_rotate_chunk_kernel"
    lib, out, lhs, sz, tables, stream = _mk_call(
        who, acc, e_chunk, bara_t, l, b, t, plan, nz, balanced)
    n_steps = e_chunk.shape[0]
    require(tuple(e_chunk.shape) == (n_steps, e_step_rows(plan, l, t, nz),
                                     4 * t),
            f"operand shape {tuple(e_chunk.shape)} does not fit the plan",
            who)
    if n_steps and sz["bsz"]:
        err = lib.tfhe_mk_blind_rotate_chunk(
            out.data_ptr(), e_chunk.data_ptr(), bara_t.data_ptr(),
            lhs.data_ptr(), *tables, sz["bsz"], sz["k1"], sz["n"], l, b,
            sz["m"], n_steps, sz["lhs_rows"], plan.total_rows, sz["nzn"],
            sz["offset"], stream)
        raise_on_error(who, lib, err)
        mk_blind_rotate_chunk_kernel.launches += 1
    return out


mk_blind_rotate_chunk_kernel.launches = 0


def mk_blind_rotate_compact_kernel(acc: torch.Tensor, limbs: torch.Tensor,
                                   bara_t: torch.Tensor, *, l: int, b: int,
                                   t: int, plan: KaratsubaPlan, nz,
                                   balanced: bool) -> torch.Tensor:
    """A party's whole loop from its compact limbs in one C call (3 CUDA
    launches per step); the same contract as
    `mk_blind_rotate_compact_plain`."""
    who = "mk_blind_rotate_compact_kernel"
    lib, out, lhs, sz, tables, stream = _mk_call(
        who, acc, limbs, bara_t, l, b, t, plan, nz, balanced)
    n_steps = limbs.shape[0]
    require(tuple(limbs.shape) == (n_steps, 4, sz["nzn"], l, 2 * sz["n"]),
            f"compact limbs {tuple(limbs.shape)}, expected "
            f"(n, 4, {sz['nzn']}, {l}, {2 * sz['n']})", who)
    masks = _device_entry_masks(plan, str(acc.device))
    scratch = torch.empty((e_step_rows(plan, l, t, nz), 4 * t),
                          dtype=torch.int8, device=acc.device)
    if n_steps and sz["bsz"]:
        err = lib.tfhe_mk_blind_rotate_compact(
            out.data_ptr(), limbs.data_ptr(), bara_t.data_ptr(),
            lhs.data_ptr(), scratch.data_ptr(), masks.data_ptr(), *tables,
            sz["bsz"], sz["k1"], sz["n"], l, b, sz["m"], n_steps,
            sz["lhs_rows"], plan.total_rows, sz["nzn"], sz["offset"], stream)
        raise_on_error(who, lib, err)
        mk_blind_rotate_compact_kernel.launches += 1
        expand_step_kernel.launches += 1  # the loop runs that kernel too
    return out


mk_blind_rotate_compact_kernel.launches = 0


# --- dispatchers ---


def expand_sparse(limbs_step: torch.Tensor, *, t: int, plan: KaratsubaPlan,
                  nz, l: int, preselected: bool) -> torch.Tensor:
    """One step's sparse expansion. CPU tensors take
    `expand_karatsuba_sparse`; CUDA tensors the expansion kernel, on the
    selected blocks viewed as a compact step of NZ*l rows and one column."""
    if not limbs_step.is_cuda:
        return expand_karatsuba_sparse(limbs_step, t, plan, nz, l,
                                       preselected)
    sel = limbs_step if preselected else select_nz_limbs(limbs_step, nz, l)
    require(tuple(sel.shape[:3]) == (4, len(nz), l),
            f"limbs {tuple(sel.shape)} do not hold {len(nz)} blocks of {l} "
            "rows", "expand_sparse")
    return expand_step_kernel(
        sel.contiguous().reshape(4, len(nz) * l, 1, sel.shape[-1]), t=t,
        plan=plan)


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
