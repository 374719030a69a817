"""The baked block-Karatsuba blind rotation: plain torch version, CUDA
kernel wrapper, and the dispatcher between them.

Counterpart of the whole-rotation kernels of `tfhe_tpu/ops/pallas_cmux.py`
(`blind_rotate_pallas_pipelined` and its serial twin
`blind_rotate_pallas_karatsuba`), which compute the same function. Both the
plain version and the kernel read the same baked key
(`karatsuba.bake_karatsuba`) and follow the same plan; the kernel gets the
plan as small int tables (`kernel_tables`).

* `blind_rotate_plain`: a loop of `mux_rotate_karatsuba` in torch ops (the
  reference's XLA path). The CPU path and the oracle for the kernel.
* `blind_rotate_kernel`: the CUDA wrapper (`csrc/blind_rotate.cu`). It
  counts its launches in `blind_rotate_kernel.launches`.
* `blind_rotate_baked`: CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from .karatsuba import KaratsubaPlan, karatsuba_delta

# The kernel's fixed tile geometry (csrc/blind_rotate.cu).
KERNEL_BLOCK = 128  # T: the Toeplitz block size the kernel takes
# Raw digits of one row, M*P*T bytes (twice that for b > 8), live in shared
# memory: up to the 227 KB a block may opt in to on Hopper.
_MAX_DIGIT_SMEM = 227 * 1024


def kernel_plan(plan: KaratsubaPlan, p: int, t: int,
                inline_combos: bool = False):
    """Lower a KaratsubaPlan into static kernel metadata, exactly as the
    reference's `_kernel_plan`. The CUDA kernels take the lowering without
    inline combos; with `inline_combos` a single-limb combo leaf gets the
    descriptor (2, entries, 0) instead of combo rows, which only
    `mk_cmux.sparse_plan` asks for, to be held against the reference's.

    Returns (combo_writes, leaf_dots, comb_rows):
    * combo_writes: ((dst_row, src_blocks, shifts, leaf_len), ...), one per
      combo-leaf entry; limb s of entry j lands at combo row
      dst_row + s*leaf_len (rows in P*T units).
    * leaf_dots: ((e_row, L, lhs_descs, contribs), ...) per leaf, with
      lhs_descs = ((buffer_id, row_start, shift), ...) per digit limb
      (buffer 0 = raw digits, 1 = combos).
    * comb_rows: total combo rows.

    Singleton single-limb leaves read the raw digit blocks directly: their
    entries are consecutive blocks by construction.
    """
    combo_writes = []
    leaf_dots = []
    comb_row = 0
    for lf in plan.leaves:
        L = lf.length
        singleton = all(len(e) == 1 for e in lf.entries)
        if singleton and lf.d_shifts == (0,):
            first = lf.entries[0][0]
            if tuple(e[0] for e in lf.entries) != tuple(range(first,
                                                              first + L)):
                raise ValueError("singleton leaf blocks are not consecutive")
            lhs_descs = ((0, first, 0),)
        elif inline_combos and lf.d_shifts == (0,):
            lhs_descs = ((2, lf.entries, 0),)
        else:
            base = comb_row
            for j, entry in enumerate(lf.entries):
                combo_writes.append((base + j, entry, lf.d_shifts, L))
            lhs_descs = tuple(
                (1, base + s * L, lf.d_shifts[s])
                for s in range(len(lf.d_shifts))
            )
            comb_row += len(lf.d_shifts) * L
        leaf_dots.append((lf.row_offset, L, lhs_descs, lf.contribs))
    return tuple(combo_writes), tuple(leaf_dots), comb_row


def kernel_tables(plan: KaratsubaPlan, p: int, t: int):
    """The plan as the kernel's int tables.

    The kernel's digit operand is one int8 row of `lhs_rows` segments of
    P*T bytes per ciphertext: segments [0, M) are the raw digit blocks,
    segment M + r is combo row r. Returns (combos, terms, term_start,
    lhs_rows), all tables as lists of ints:

    * combos[c] = (dst_seg, src_block_mask, two_limb, hi_seg): segment
      dst_seg gets the sum of the masked digit blocks, as one int8 limb, or
      as the low limb with the high limb (shift 7) at hi_seg.
    * terms[i] = (posm, lhs_seg, e_seg, nseg, shift, sign): output block
      posm gets sign * 2^shift * (lhs segments [lhs_seg, lhs_seg+nseg) .
      key row segments [e_seg, e_seg+nseg)), all mod 2^32. Sorted by posm.
    * term_start: M+1 offsets of each output block's terms.
    """
    m = plan.m
    combo_writes, leaf_dots, comb_rows = kernel_plan(plan, p, t)
    combos = []
    for dst_row, src_blocks, shifts, leaf_len in combo_writes:
        mask = sum(1 << blk for blk in src_blocks)
        combos.append((m + dst_row, mask, int(len(shifts) == 2),
                       m + dst_row + leaf_len))
    terms = []
    for e_row, L, lhs_descs, contribs in leaf_dots:
        for o in range(2 * L - 1):
            i0, i1 = max(0, o - L + 1), min(L - 1, o)
            for buf_id, row0, shift in lhs_descs:
                lhs_seg = (m if buf_id else 0) + row0 + i0
                e_seg = e_row + L - 1 - o + i0
                for off, sgn in contribs:
                    pos = off + o
                    if pos >= 2 * m - 1:
                        continue
                    sgn_f = sgn if pos < m else -sgn
                    terms.append((pos % m, lhs_seg, e_seg, i1 - i0 + 1,
                                  shift, sgn_f))
    terms.sort(key=lambda tm: tm[0])  # stable: plan order within a block
    term_start = [0] * (m + 1)
    for tm in terms:
        term_start[tm[0] + 1] += 1
    for i in range(m):
        term_start[i + 1] += term_start[i]
    return combos, terms, term_start, m + comb_rows


def mux_rotate_karatsuba(acc_a: torch.Tensor, e_i: torch.Tensor,
                         barai: torch.Tensor, decomp_length: int,
                         log2_base: int, block: int, plan: KaratsubaPlan,
                         balanced: bool = False) -> torch.Tensor:
    """One CMUX against a Karatsuba-baked key step:
    acc += BK_i (x) [(X^bara_i - 1) * acc].

    acc_a: int32[B, k+1, N]; e_i: int8[total_rows*P*T, K*4*T];
    barai: int32[B]. Branchless: bara_i == 0 gives all-zero digits.
    """
    b_sz, kp1, n = acc_a.shape
    rot = mul_by_monomial(acc_a, barai[:, None])
    digits = decompose(rot - acc_a, decomp_length, log2_base, balanced)
    digits = digits.reshape(b_sz, kp1 * decomp_length, n)
    return acc_a + karatsuba_delta(digits, e_i, block, plan)


def blind_rotate_plain(acc: torch.Tensor, e_all: torch.Tensor,
                       bara_t: torch.Tensor, *, l: int, b: int, t: int,
                       plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """Whole blind rotation in torch ops: acc int32[B, K, N]; e_all
    int8[n, total_rows*P*T, K*4*T]; bara_t int32[n, B]. Returns the rotated
    accumulator, int32[B, K, N]."""
    for s in range(e_all.shape[0]):
        acc = mux_rotate_karatsuba(acc, e_all[s], bara_t[s], l, b, t, plan,
                                   balanced)
    return acc


def int_table(rows, device) -> torch.Tensor:
    """A list of int rows as one flat int32 tensor on `device`."""
    flat = [v for row in rows for v in row] or [0]
    return torch.tensor(flat, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def device_tables(plan: KaratsubaPlan, p: int, t: int, device: str):
    combos, terms, term_start, lhs_rows = kernel_tables(plan, p, t)
    return (int_table(combos, device), len(combos), int_table(terms, device),
            int_table([term_start], device), lhs_rows)


def require(cond: bool, what: str, who: str):
    if not cond:
        raise ValueError(f"{who}: {what}")


def check_rotation_geometry(who: str, k1: int, n: int, l: int, b: int,
                            t: int, plan: KaratsubaPlan):
    """The shapes the rotation kernels serve: T = 128, N a power of two with
    at most 31 blocks, a gadget that fits 32-bit words and int16 digits, and
    one row's raw digits (M*K*l*T bytes, twice that for b > 8) within the
    shared memory a block can use. Every single-key preset and the
    multi-key shapes up to 8 parties (K = 9, l = 8: 73,728 bytes) fit.
    Returns (M, P*T)."""
    def check(cond, what):
        require(cond, what, who)

    check(t == KERNEL_BLOCK, f"block T must be {KERNEL_BLOCK}, got {t}")
    check(1 <= b <= 15 and l * b <= 32,
          f"gadget l={l}, b={b} does not fit 32-bit words and int16 digits")
    m = n // t
    pt = k1 * l * t
    check(n == m * t and n & (n - 1) == 0 and plan.m == m,
          f"plan m={plan.m} does not fit N={n} (a power of two)")
    check(m <= 31, "at most 31 blocks per polynomial")
    # raw digits of one row in shared memory: bytes for b <= 8, else int16
    digit_bytes = m * pt * (1 if b <= 8 else 2)
    check(digit_bytes <= _MAX_DIGIT_SMEM,
          f"one row's digits (K={k1}, l={l}, N={n}: {digit_bytes} bytes) "
          f"exceed the {_MAX_DIGIT_SMEM} bytes of shared memory a block "
          "can use")
    return m, pt


def check_rotation_args(who: str, acc: torch.Tensor, key: torch.Tensor,
                        bara_t: torch.Tensor, l: int, b: int, t: int,
                        plan: KaratsubaPlan):
    """What every whole-rotation kernel wrapper requires of its arguments;
    returns (batch, k1, N, M, P*T). `key` is the baked or the compact key."""
    def check(cond, what):
        require(cond, what, who)

    check(acc.dim() == 3 and key.dim() >= 3 and bara_t.dim() == 2,
          "acc must be [B, K, N], bara_t [n, B]")
    check(acc.is_cuda and key.is_cuda and bara_t.is_cuda,
          "tensors must be on a CUDA device")
    check(acc.device == key.device == bara_t.device,
          "tensors must share one device")
    check(acc.dtype == torch.int32 and bara_t.dtype == torch.int32
          and key.dtype == torch.int8, "dtypes must be int32/int8/int32")
    check(acc.is_contiguous() and key.is_contiguous()
          and bara_t.is_contiguous(), "tensors must be contiguous")
    bsz, k1, n = acc.shape
    m, pt = check_rotation_geometry(who, k1, n, l, b, t, plan)
    check(tuple(bara_t.shape) == (key.shape[0], bsz),
          f"bara_t must be [{key.shape[0]}, {bsz}], "
          f"got {tuple(bara_t.shape)}")
    return bsz, k1, n, m, pt


def raise_on_error(who: str, lib, err: int):
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} "
                           f"({lib.tfhe_error_string(err).decode()})")


def blind_rotate_kernel(acc: torch.Tensor, e_all: torch.Tensor,
                        bara_t: torch.Tensor, *, l: int, b: int, t: int,
                        plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """Whole blind rotation through the CUDA kernel; the same contract as
    `blind_rotate_plain`. Takes T = 128 only. Launches on the current
    stream and does not synchronise."""
    from . import _build

    who = "blind_rotate_kernel"
    bsz, k1, n, m, pt = check_rotation_args(who, acc, e_all, bara_t, l, b, t,
                                            plan)
    n_steps = e_all.shape[0]
    require(tuple(e_all.shape) == (n_steps, plan.total_rows * pt, k1 * 4 * t),
            f"baked key shape {tuple(e_all.shape)} does not fit the plan", who)

    lib = _build.load()
    combos, n_combos, terms, term_start, lhs_rows = device_tables(
        plan, k1 * l, t, str(acc.device))
    out = acc.clone()
    lhs = torch.empty((bsz, lhs_rows * pt), dtype=torch.int8,
                      device=acc.device)
    if n_steps and bsz:
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.tfhe_blind_rotate(
            out.data_ptr(), e_all.data_ptr(), bara_t.data_ptr(),
            lhs.data_ptr(), combos.data_ptr(), n_combos, terms.data_ptr(),
            term_start.data_ptr(), bsz, k1, n, l, b, m, n_steps, lhs_rows,
            plan.total_rows, decomp_offset(l, b, balanced),
            ctypes.c_void_p(stream))
        raise_on_error(who, lib, err)
        blind_rotate_kernel.launches += 1
    return out


blind_rotate_kernel.launches = 0


def blind_rotate_baked(acc: torch.Tensor, e_all: torch.Tensor,
                       bara_t: torch.Tensor, *, l: int, b: int, t: int,
                       plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = blind_rotate_kernel if acc.is_cuda else blind_rotate_plain
    return fn(acc, e_all, bara_t, l=l, b=b, t=t, plan=plan,
              balanced=balanced)
