"""The baked block-Karatsuba blind rotation: plain torch version, CUDA
kernel wrapper, and the dispatcher between them.

Counterpart of the whole-rotation kernels of `tfhe_tpu/ops/pallas_cmux.py`
(`blind_rotate_pallas_pipelined` and its serial twin
`blind_rotate_pallas_karatsuba`), which compute the same function. Both the
plain version and the kernel read the key `karatsuba.bake_karatsuba` bakes
and follow the same plan: the plain version in the reference layout, the
kernel K-major (`dots.to_kmajor`, the layout a key takes on the card). The
kernel gets the plan as small int tables: `kernel_tables`' combo writes and
`product_tables`' products, each distinct product once with the output
blocks it feeds.

* `blind_rotate_plain`: a loop of `mux_rotate_karatsuba` in torch ops (the
  reference's XLA path). The CPU path and the oracle for the kernel.
* `blind_rotate_kernel`: the CUDA wrapper (`csrc/blind_rotate.cu`). It
  counts its launches (`instrument` counter "blind_rotate"), and raises on
  a key in the reference layout.
* `blind_rotate_baked`: CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise.
* `digit_rows_plain` / `digit_rows_kernel` / `digit_rows`: the first launch
  of every rotation step on its own (rotate, decompose, Karatsuba digit
  combos: the digit operand the dots read), for the single-key and the
  multi-key steps alike.
* `rotation_launch`: the one prologue of every rotation kernel wrapper
  (this module's, `compact`'s, `cmux_step`'s, `mk_cmux`'s and
  `fused_step`'s): the argument check (`check_rotation_args`,
  `check_rotation_geometry`), the library, the step's `StepSizes` and the
  dots' `dots.DotsArgs` (the two structs every rotation C entry takes),
  the output and the digit rows.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..instrument import cached_build, count, span
from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from . import dots
from .karatsuba import KaratsubaPlan, karatsuba_delta

# The kernel's fixed tile geometry (csrc/blind_rotate.cu).
KERNEL_BLOCK = 128  # T: the Toeplitz block size the kernel takes
# The rotate/decompose kernel stages one accumulator row (K*N words) in
# shared memory: up to the 227 KB a block may opt in to on Hopper.
MAX_ROW_SMEM = 227 * 1024
# Its combo table travels in the launch's parameters (csrc/cmux_kernels.cuh:
# kMaxCombos), one packed word per combo; segments are 7-bit fields.
MAX_COMBOS = 64
MAX_LHS_ROWS = 128


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
    """The plan as int tables: the combo writes rotate_decompose_kernel
    reads, and the plan's terms one per (product, output block), which
    `product_tables` groups by product for the dots kernels.

    The digit operand is one int8 row of `lhs_rows` segments of P*T bytes
    per ciphertext: segments [0, M) are the raw digit blocks, segment M + r
    is combo row r. Returns (combos, terms, term_start, lhs_rows), all
    tables as lists of ints:

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


def product_tables(plan: KaratsubaPlan, p: int, t: int) -> tuple:
    """`kernel_tables`' terms with each distinct product once: one entry
    (lhs_seg, e_seg, nseg, shift, targets) per (leaf, linear-convolution
    output, digit limb), targets = ((posm, sign), ...) the output blocks
    its contributions fold to. Expanded over its targets, every entry gives
    back exactly `kernel_tables`' terms (as a multiset); the plan never
    folds two contributions of one product onto one output block."""
    m = plan.m
    _, leaf_dots, _ = kernel_plan(plan, p, t)
    products = []
    for e_row, L, lhs_descs, contribs in leaf_dots:
        for o in range(2 * L - 1):
            i0, i1 = max(0, o - L + 1), min(L - 1, o)
            targets = tuple((pos % m, sgn if pos < m else -sgn)
                            for pos, sgn in ((off + o, sgn)
                                             for off, sgn in contribs)
                            if pos < 2 * m - 1)
            if len({posm for posm, _ in targets}) != len(targets):
                raise ValueError("two contributions fold onto one block")
            if not targets:
                continue
            for buf_id, row0, shift in lhs_descs:
                products.append(((m if buf_id else 0) + row0 + i0,
                                 e_row + L - 1 - o + i0, i1 - i0 + 1, shift,
                                 targets))
    return tuple(products)


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


def digit_rows_plain(acc: torch.Tensor, bara: torch.Tensor, combos,
                     lhs_rows: int, *, l: int, b: int, t: int,
                     offset: int) -> torch.Tensor:
    """The digit operand of one step, the function of the first launch of
    every rotation kernel: acc int32[B, K, N], bara int32[B] (any integer;
    reduced mod 2N), combos as `kernel_tables` gives them, `offset` the
    decomposition offset. Returns int8[B, lhs_rows*P*T], per ciphertext
    `lhs_rows` segments of P*T bytes, each laid out [j][level][u]:

    * segments [0, M): the raw digits of block i of
      (X^bara - 1) * acc + offset, cut into l signed b-bit digits; for
      b > 8 they do not fit a byte, no product reads them, and they are
      not part of the function: zero here, left unwritten by the kernel;
    * each combo's segment: the sum of its masked blocks' digits, one int8
      (wrapped mod 2^8), or for a two-limb combo lo = ((v & 127) ^ 64) - 64
      at dst_seg and hi = (v - lo) / 128 at hi_seg.
    """
    bsz, k1, n = acc.shape
    m, pt = n // t, k1 * l * t
    rot = mul_by_monomial(acc, bara.to(torch.int64)[:, None])
    shifted = (rot.to(torch.int64) - acc + offset) & 0xFFFFFFFF
    dig = torch.stack([((shifted >> (32 - (il + 1) * b)) & ((1 << b) - 1))
                       - (1 << (b - 1)) for il in range(l)], dim=2)
    dig = dig.reshape(bsz, k1, l, m, t).permute(0, 3, 1, 2, 4) \
        .reshape(bsz, m, pt)  # [B, block i, (j, level, u)]
    lhs = torch.zeros((bsz, lhs_rows, pt), dtype=torch.int64,
                      device=acc.device)
    if b <= 8:
        lhs[:, :m] = dig
    for dst, mask, two_limb, hi in combos:
        v = sum(dig[:, blk] for blk in range(m) if mask >> blk & 1)
        if two_limb:
            lo = ((v & 127) ^ 64) - 64
            lhs[:, hi] = (v - lo) // 128
            v = lo
        lhs[:, dst] = v
    lhs = ((lhs + 128) & 255) - 128  # the kernel's byte stores
    return lhs.to(torch.int8).reshape(bsz, lhs_rows * pt)


def digit_row_defined(b: int, m: int, pt: int) -> int:
    """The first byte of a digit row that `digit_rows_plain` defines: 0, or
    M*P*T for b > 8, whose raw segments are not part of the function."""
    return 0 if b <= 8 else m * pt


def pack_combos(combos) -> list:
    """`kernel_tables`' combos as the kernel's parameter words:
    src_block_mask | two_limb << 16 | dst_seg << 17 | hi_seg << 24 (hi_seg
    0 for a single-limb combo, which has none)."""
    return [mask | two << 16 | dst << 17 | (hi if two else 0) << 24
            for dst, mask, two, hi in combos]


def combo_words(combos, m: int, lhs_rows: int) -> list:
    """`pack_combos`, checked against what the kernel takes: at most
    MAX_COMBOS combos of 1-16 blocks, segments inside a row of at most
    MAX_LHS_ROWS. Raises ValueError otherwise."""
    words = pack_combos(combos)
    ok = len(words) <= MAX_COMBOS and lhs_rows <= MAX_LHS_ROWS and all(
        0 < (w & 0xFFFF) < 1 << m and ((w >> 17) & 127) < lhs_rows
        and ((w >> 24) & 127) < lhs_rows for w in words)
    if not ok:
        raise ValueError(f"the combo table ({len(words)} combos, "
                         f"{lhs_rows} segments, M={m}) does not fit the "
                         "kernel or the row")
    return words


def digit_row_stores(k1: int, n: int, l: int, b: int, combos,
                     t: int = KERNEL_BLOCK) -> list:
    """The byte offsets, within one digit row, of every 4-byte store the
    rotate/decompose kernel makes for that row (csrc/cmux_kernels.cuh), in
    its lane order: a warp per poly j (from M = 8 on, per (j, level il))
    of the row, lane u4 holding coefficients [4*u4, 4*u4 + 4) of every
    block; per level it stores the raw word of each block (b <= 8), then
    each combo's word(s)."""
    m, pt = n // t, k1 * l * t
    stores = []
    for j in range(k1):
        for il in range(l):
            for u4 in range(t // 4):
                lane = (j * l + il) * t + 4 * u4
                if b <= 8:
                    stores += [i * pt + lane for i in range(m)]
                for dst, _, two_limb, hi in combos:
                    stores += [seg * pt + lane
                               for seg in ((dst, hi) if two_limb else (dst,))]
    return stores


@cached_build("combo_table")
def combo_table(plan: KaratsubaPlan, p: int, t: int):
    """The combo table as the C entries take it, a host int32 tensor of
    `pack_combos` words: (table, n_combos, lhs_rows)."""
    combos, _, _, lhs_rows = kernel_tables(plan, p, t)
    words = combo_words(combos, plan.m, lhs_rows)
    return (torch.tensor(words or [0], dtype=torch.int32), len(combos),
            lhs_rows)


class StepSizes(ctypes.Structure):
    """A rotation C entry's sizes and combo table (csrc/cmux_kernels.cuh:
    StepSizes): the batch, K, N, the gadget l and b, M = N/T, the digit
    row's segments of P*T bytes, the key's rows of P*T bytes a step, the
    decomposition offset, and n_combos `pack_combos` words in host memory
    (`combo_table`), which the C call copies into its launches."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "k1", "n", "l", "b", "m", "lhs_rows", "total_rows", "offset",
        "n_combos")] + [("combos", ctypes.c_void_p)]


@cached_build("dots_tables")
def dots_tables(plan: KaratsubaPlan, k1: int, l: int,
                t: int) -> dots.DotsTables:
    """`product_tables` as the dots kernel's rows."""
    return dots.encode_single_key(product_tables(plan, k1 * l, t), k1, plan.m,
                                  k1 * l * t)


def require(cond: bool, what: str, who: str):
    if not cond:
        raise ValueError(f"{who}: {what}")


def check_rotation_geometry(who: str, k1: int, n: int, l: int, b: int,
                            t: int, plan: KaratsubaPlan | None = None):
    """The shapes the rotation kernels serve: T = 128, N a power of two of
    1 to 16 blocks, a gadget that fits 32-bit words and int16 digits, one
    accumulator row (K*N words) within the shared memory a block can use,
    and, where the launch follows a Karatsuba plan, a plan of N/T blocks
    with at most 64 combos and 128 digit segments. Every single-key preset
    and the multi-key shapes up to 8 parties (K = 9, N = 1024: 36,864 bytes
    a row) fit. Returns (M, P*T)."""
    def check(cond, what):
        require(cond, what, who)

    check(t == KERNEL_BLOCK, f"block T must be {KERNEL_BLOCK}, got {t}")
    check(1 <= b <= 15 and l * b <= 32,
          f"gadget l={l}, b={b} does not fit 32-bit words and int16 digits")
    m = n // t
    pt = k1 * l * t
    check(n == m * t and n & (n - 1) == 0 and 1 <= m <= 16,
          f"N={n} must be a power of two of 1 to 16 blocks of T")
    if plan is not None:
        check(plan.m == m, f"plan m={plan.m} does not fit N={n}")
    try:  # the dots kernel's word sums (M x 8 KB) beside a 3-slot ring
        dots.ring_stages(m)
    except ValueError as err:
        raise ValueError(f"{who}: {err}") from None
    row_bytes = k1 * n * 4  # one accumulator row, staged in shared memory
    check(row_bytes <= MAX_ROW_SMEM,
          f"one accumulator row (K={k1}, N={n}: {row_bytes} bytes) exceeds "
          f"the {MAX_ROW_SMEM} bytes of shared memory a block can use")
    if plan is not None:
        try:
            combo_table(plan, k1 * l, t)
        except ValueError as err:
            raise ValueError(f"{who}: {err}") from None
    return m, pt


def check_rotation_args(who: str, acc: torch.Tensor, key: torch.Tensor | None,
                        bara_t: torch.Tensor | None, l: int, b: int, t: int,
                        plan: KaratsubaPlan | None = None):
    """What every rotation kernel wrapper requires of its tensors: acc
    int32[B, K, N], the int8 key (baked, compact, dense or an operand, its
    steps first) and bara_t int32[n, B], where the launch takes them, all
    contiguous on one CUDA device, at a geometry `check_rotation_geometry`
    serves. Returns (batch, k1, N, M, P*T)."""
    def check(cond, what):
        require(cond, what, who)

    tensors = [x for x in (acc, key, bara_t) if x is not None]
    check(acc.dim() == 3 and (key is None or key.dim() >= 3)
          and (bara_t is None or bara_t.dim() == 2),
          "acc must be [B, K, N], bara_t [n, B]")
    check(all(x.is_cuda for x in tensors), "tensors must be on a CUDA device")
    check(all(x.device == acc.device for x in tensors),
          "tensors must share one device")
    check(acc.dtype == torch.int32
          and (bara_t is None or bara_t.dtype == torch.int32)
          and (key is None or key.dtype == torch.int8),
          "dtypes must be int32/int8/int32")
    check(all(x.is_contiguous() for x in tensors),
          "tensors must be contiguous")
    bsz, k1, n = acc.shape
    m, pt = check_rotation_geometry(who, k1, n, l, b, t, plan)
    if bara_t is not None:
        steps = bara_t.shape[0] if key is None else key.shape[0]
        check(tuple(bara_t.shape) == (steps, bsz),
              f"bara_t must be [{steps}, {bsz}], got {tuple(bara_t.shape)}")
    return bsz, k1, n, m, pt


def raise_on_error(who: str, lib, err: int):
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} "
                           f"({lib.tfhe_error_string(err).decode()})")


class Launch(NamedTuple):
    """What `rotation_launch` prepares for one rotation C entry call."""

    lib: ctypes.CDLL
    sizes: StepSizes
    dots: dots.DotsArgs | None  # None where no dots launch
    out: torch.Tensor | None  # the copy of acc the dots add into
    lhs: torch.Tensor  # the digit rows, B x lhs_rows*P*T bytes
    stream: ctypes.c_void_p
    pt: int  # P*T, the bytes of a digit segment
    combos: torch.Tensor  # the words `sizes` points at, held


def rotation_launch(who: str, acc: torch.Tensor, key: torch.Tensor | None,
                    bara_t: torch.Tensor | None, *, l: int, b: int, t: int,
                    offset: int, plan: KaratsubaPlan | None = None,
                    combos: tuple | None = None,
                    tables: Callable[[], dots.DotsTables] | None = None,
                    lhs: torch.Tensor | None = None,
                    calls: int = 1) -> Launch:
    """The prologue of every rotation kernel wrapper: `check_rotation_args`
    on its tensors (key and bara_t with their steps first, None where the
    launch takes none), then the library, the two structs the C entry takes
    and its buffers, on acc's device and current stream.

    * plan: the Karatsuba plan, whose `combo_table` the launch takes;
      without one, combos = (the caller's combos as `kernel_tables` gives
      them, lhs_rows), checked by `combo_words`.
    * tables: makes the dots' tables (called after the check), which
      `dots.dots_args` puts on the device and counts as `calls` C calls,
      unless the batch or the key's steps are empty and nothing launches;
      with them `out` is a copy of acc that the dots add into.
    * lhs: the digit rows where the caller has them, else new ones.

    The wrapper's own checks (the key's layout, the compact limbs, the
    multi-key blocks) follow, then its C call."""
    from . import _build

    bsz, k1, n, m, pt = check_rotation_args(who, acc, key, bara_t, l, b, t,
                                            plan)
    if plan is not None:
        words, n_combos, lhs_rows = combo_table(plan, k1 * l, t)
    else:
        given, lhs_rows = combos
        try:
            packed = combo_words(given, m, lhs_rows)
        except ValueError as err:
            raise ValueError(f"{who}: {err}") from None
        words = torch.tensor(packed or [0], dtype=torch.int32)
        n_combos = len(packed)
    lib = _build.load()
    sizes = StepSizes(bsz, k1, n, l, b, m, lhs_rows,
                      0 if plan is None else plan.total_rows, offset,
                      n_combos, words.data_ptr())
    steps = bara_t.shape[0] if key is None else key.shape[0]
    args, out = None, None
    if tables is not None:
        out = acc.clone()
        if bsz and steps:
            args = dots.dots_args(tables(), bsz, acc.device, calls)
    if lhs is None:
        lhs = torch.empty((bsz, lhs_rows * pt), dtype=torch.int8,
                          device=acc.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(acc.device).cuda_stream)
    return Launch(lib, sizes, args, out, lhs, stream, pt, words)


def digit_rows_kernel(acc: torch.Tensor, bara: torch.Tensor, combos,
                      lhs_rows: int, *, l: int, b: int, t: int,
                      offset: int) -> torch.Tensor:
    """`digit_rows_plain` through the CUDA kernel alone (C entry
    tfhe_rotate_decompose_rows), the first launch of every rotation step.
    For b > 8 the raw segments are left unwritten (`digit_row_defined`).
    Launches on the current stream and does not synchronise. The
    `instrument` counter "rotate_decompose_rows" counts this kernel's
    launches, those the whole-rotation wrappers make included."""
    who = "digit_rows_kernel"
    run = rotation_launch(who, acc, None, bara[None], l=l, b=b, t=t,
                          offset=offset, combos=(combos, lhs_rows))
    if run.sizes.batch:
        err = run.lib.tfhe_rotate_decompose_rows(
            acc.data_ptr(), bara.data_ptr(), run.lhs.data_ptr(), run.sizes,
            run.stream)
        raise_on_error(who, run.lib, err)
        count("rotate_decompose_rows")
    return run.lhs


def digit_rows(acc: torch.Tensor, bara: torch.Tensor, combos, lhs_rows: int,
               *, l: int, b: int, t: int, offset: int) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = digit_rows_kernel if acc.is_cuda else digit_rows_plain
    return fn(acc, bara, combos, lhs_rows, l=l, b=b, t=t, offset=offset)


def blind_rotate_kernel(acc: torch.Tensor, e_all: torch.Tensor,
                        bara_t: torch.Tensor, *, l: int, b: int, t: int,
                        plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """Whole blind rotation through the CUDA kernels; the contract of
    `blind_rotate_plain`, with the key K-major: e_all int8[n, K, 4, T,
    total_rows*P*T] (`dots.to_kmajor` of the bake). Takes T = 128 only.
    Launches on the current stream and does not synchronise."""
    who = "blind_rotate_kernel"
    run = rotation_launch(
        who, acc, e_all, bara_t, l=l, b=b, t=t,
        offset=decomp_offset(l, b, balanced), plan=plan,
        tables=lambda: dots_tables(plan, acc.shape[1], l, t))
    n_steps = e_all.shape[0]
    dots.require_kmajor(who, e_all, (n_steps,), run.sizes.k1, t,
                        plan.total_rows * run.pt)
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_blind_rotate(
                run.out.data_ptr(), e_all.data_ptr(), bara_t.data_ptr(),
                run.lhs.data_ptr(), run.sizes, run.dots, n_steps, run.stream)
        raise_on_error(who, run.lib, err)
        count("blind_rotate")
        count("rotate_decompose_rows", n_steps)  # its first launch of a step
    return run.out


def blind_rotate_baked(acc: torch.Tensor, e_all: torch.Tensor,
                       bara_t: torch.Tensor, *, l: int, b: int, t: int,
                       plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = blind_rotate_kernel if acc.is_cuda else blind_rotate_plain
    return fn(acc, e_all, bara_t, l=l, b=b, t=t, plan=plan,
              balanced=balanced)
