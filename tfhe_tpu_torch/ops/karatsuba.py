"""Block-level Karatsuba for the CMUX contraction, exact mod 2^32.

Counterpart of `tfhe_tpu/ops/karatsuba.py`, without its column sharding. The
negacyclic N x N Toeplitz of a key polynomial splits into T x T blocks W_d
with W_{d+M} = -W_d (M = N/T), so one external product is the polynomial
product C(z) = D(z) E(z) mod z^M + 1 over the block index. Karatsuba over z
cuts the M^2 block products to 3 per level; the key-side combos are baked
in int32 and limb-split, the digit-side combos are formed at gate time and
split into one int8 limb, or two (shifts 0 and 7) when they may leave
[-128, 127].
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .conv import i8_matmul, split_torus_limbs


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One Karatsuba leaf: a linear convolution of two length-L combo
    sequences (the same index-sets on the digit and the key side)."""

    entries: tuple  # L tuples of original block indices to sum
    contribs: tuple  # ((offset, sign), ...): placement in C(z)
    row_offset: int  # first super-block row of this leaf in the baked key
    d_shifts: tuple  # digit-side limb shifts: (0,) or (0, 7)

    @property
    def length(self) -> int:
        return len(self.entries)


@dataclasses.dataclass(frozen=True)
class KaratsubaPlan:
    m: int  # blocks per polynomial (N / T)
    depth: int
    log2_base: int
    leaves: tuple  # tuple[Leaf]
    total_rows: int  # super-block rows in the baked key

    @property
    def macs_superblocks(self) -> int:
        """Super-block products per step (dense = m^2 per limb set)."""
        total = 0
        for lf in self.leaves:
            L = lf.length
            total += len(lf.d_shifts) * sum(
                min(L - 1, o) - max(0, o - L + 1) + 1 for o in range(2 * L - 1)
            )
        return total


def _digit_limb_shifts(bound: int) -> tuple:
    """Exact int8 limb shifts for combos in [-bound, bound - 1]."""
    if bound <= 128:
        return (0,)
    if (bound + 64) // 128 + 1 > 128:
        raise ValueError(f"combo bound {bound} needs more than two limbs")
    return (0, 7)


@functools.lru_cache(maxsize=None)
def karatsuba_plan(m: int, depth: int, log2_base: int) -> KaratsubaPlan:
    """Static recursion metadata for a depth-`depth` split of length-m block
    sequences; depth 0 is the dense linear convolution as one leaf."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"m must be a power of 2, got {m}")
    depth = min(depth, m.bit_length() - 1)
    leaves = []

    def rec(entries, contribs, d):
        L = len(entries)
        if d == 0 or L == 1:
            acc = {}
            for off, sgn in contribs:
                acc[off] = acc.get(off, 0) + sgn
            contribs_c = tuple(sorted((o, s) for o, s in acc.items() if s))
            bound = (1 << (log2_base - 1)) * len(entries[0])
            leaves.append((entries, contribs_c, _digit_limb_shifts(bound)))
            return
        h = L // 2
        lo, hi = entries[:h], entries[h:]
        su = tuple(tuple(sorted(lo[j] + hi[j])) for j in range(h))
        rec(lo, [(o, s) for o, s in contribs]
            + [(o + h, -s) for o, s in contribs], d - 1)
        rec(hi, [(o + 2 * h, s) for o, s in contribs]
            + [(o + h, -s) for o, s in contribs], d - 1)
        rec(su, [(o + h, s) for o, s in contribs], d - 1)

    rec(tuple((i,) for i in range(m)), [(0, 1)], depth)

    out, row = [], 0
    for entries, contribs, shifts in leaves:
        out.append(Leaf(entries, contribs, row, shifts))
        row += len(entries)
    return KaratsubaPlan(m, depth, log2_base, tuple(out), row)


def _block_window_index(n: int, t: int, device) -> torch.Tensor:
    """[M, T(u), T(w)] index: W_d[u, w] = doubled[(d*T + w - u) mod 2N]."""
    m = n // t
    d = torch.arange(m, device=device)[:, None, None]
    u = torch.arange(t, device=device)[None, :, None]
    w = torch.arange(t, device=device)[None, None, :]
    return torch.remainder(d * t + w - u, 2 * n)


def entry_rows(plan: KaratsubaPlan) -> tuple:
    """The baked key's super-block rows in storage order: per leaf, its
    entries REVERSED. Row r of the bake holds the sum of the Toeplitz
    blocks named by entry_rows(plan)[r]."""
    return tuple(entry for lf in plan.leaves for entry in reversed(lf.entries))


def _bake_steps(limbs: torch.Tensor, t: int, plan: KaratsubaPlan,
                idx: torch.Tensor) -> torch.Tensor:
    """[c, 4, P, K, 2N] int8 -> [c, R*P*T, K*4*T] int8 (see bake_karatsuba)."""
    c, _, p, k, _ = limbs.shape
    m = plan.m
    l32 = limbs.to(torch.int32)
    words = l32[:, 0] + (l32[:, 1] << 8) + (l32[:, 2] << 16) + (l32[:, 3] << 24)
    blocks = words[..., idx.reshape(-1)].reshape(c, p, k, m, t, t)
    rows = []
    for entry in entry_rows(plan):
        comb = blocks[:, :, :, entry[0]]
        for d in entry[1:]:
            comb = comb + blocks[:, :, :, d]  # int32 wraparound: exact
        rows.append(comb)  # [c, P, K, T, T]
    e = split_torus_limbs(torch.stack(rows, dim=1))  # [4, c, R, P, K, T, T]
    e = e.permute(1, 2, 3, 5, 4, 0, 6)  # [c, R, P, T(u), K, 4, T(w)]
    return e.reshape(c, plan.total_rows * p * t, k * 4 * t)


def bake_karatsuba(limbs_doubled: torch.Tensor, t: int, plan: KaratsubaPlan,
                   chunk: int = 8) -> torch.Tensor:
    """Bake per-leaf key combos into int8 matmul operands.

    limbs_doubled: int8[n_steps, 4, P, K, 2N] (prepare_shared_torus output).
    Returns E: int8[n_steps, total_rows * P * T, K * 4 * T]; leaf `lf` owns
    rows [lf.row_offset * P*T, (lf.row_offset + L) * P*T), entries stored
    reversed so each linear-convolution output reads one contiguous slice.
    Rows are (entry, p, u), columns (k, limb, w). Built `chunk` steps at a
    time into one preallocated tensor, so temporaries stay small next to
    the multi-GB result.
    """
    steps, _, p, k, n2 = limbs_doubled.shape
    n = n2 // 2
    if plan.m != n // t:
        raise ValueError(f"plan has m={plan.m}, key has N/T={n // t}")
    idx = _block_window_index(n, t, limbs_doubled.device)
    out = torch.empty((steps, plan.total_rows * p * t, k * 4 * t),
                      dtype=torch.int8, device=limbs_doubled.device)
    for s0 in range(0, steps, chunk):
        out[s0:s0 + chunk] = _bake_steps(limbs_doubled[s0:s0 + chunk], t,
                                         plan, idx)
    return out


def expand_karatsuba_step(limbs_step: torch.Tensor, t: int,
                          plan: KaratsubaPlan) -> torch.Tensor:
    """Gate-time expansion of ONE step's compact key into the leaf layout.

    limbs_step: int8[4, P, K, 2N] (one step of `prepare_tgsw`). Returns
    int8[total_rows*P*T, K*4*T], byte-equal to that step of
    `bake_karatsuba`: the doubled words are rebuilt from the four bytes,
    each entry's 2T-word windows (window d starts at d*T - T, mod 2N) are
    summed in int32 with wraparound, re-split into balanced bytes, and the
    Toeplitz block W[u, w] = C[T + w - u] is gathered from the window.
    """
    _, p, k, n2 = limbs_step.shape
    n = n2 // 2
    if plan.m != n // t:
        raise ValueError(f"plan has m={plan.m}, key has N/T={n // t}")
    dev = limbs_step.device
    l32 = limbs_step.to(torch.int32)
    words = l32[0] + (l32[1] << 8) + (l32[2] << 16) + (l32[3] << 24)
    j = torch.arange(2 * t, device=dev)
    combos = []
    for entry in entry_rows(plan):
        comb = words[..., torch.remainder(entry[0] * t - t + j, n2)]
        for d in entry[1:]:
            comb = comb + words[..., torch.remainder(d * t - t + j, n2)]
        combos.append(comb)  # [P, K, 2T] int32, wraparound sums: exact
    lb = split_torus_limbs(torch.stack(combos))  # [4, R, P, K, 2T] int8
    u = torch.arange(t, device=dev)[:, None]
    w = torch.arange(t, device=dev)[None, :]
    e = lb[..., (t + w - u).reshape(-1)]  # [4, R, P, K, T(u)*T(w)]
    e = e.reshape(4, plan.total_rows, p, k, t, t).permute(1, 2, 4, 3, 0, 5)
    return e.reshape(plan.total_rows * p * t, k * 4 * t)


def select_nz_limbs(limbs: torch.Tensor, nz, l: int) -> torch.Tensor:
    """The nonzero (block row j, output column k) blocks of a dense
    prepared multi-key operand, stacked in `nz` order:
    int8[..., 4, P, K, 2N] -> int8[..., 4, NZ, l, 2N] (contiguous). The one
    place that knows how a sparse-stored key relates to a dense one: the
    plain expansion, the compact rotation's key selection and the tests
    share it."""
    return torch.stack([limbs[..., j * l:(j + 1) * l, kc, :]
                        for (j, kc) in nz], dim=-3)


def expand_karatsuba_sparse(limbs_step: torch.Tensor, t: int,
                            plan: KaratsubaPlan, nz, l: int,
                            preselected: bool = False) -> torch.Tensor:
    """Sparse-block variant of `expand_karatsuba_step` for the multi-key
    operand, whose (parties+1)^2 block matrix is mostly structural zeros:
    expands only the `nz` (block row j, output column k) pairs.

    limbs_step: int8[4, P=K*l, K, 2N] (dense prepared rows), or with
    preselected=True int8[4, NZ, l, 2N] (a sparse-stored key, same nz
    order). Returns int8[total_rows * NZ * l * T, 4 * T]: rows (entry r in
    `entry_rows` order, nz index z, l', u), columns (limb, w) of that
    block's single output column. Each selected block is a one-column key
    row, so this is `expand_karatsuba_step` on int8[4, NZ*l, 1, 2N] (a
    gather; the reference's one-hot matmul is how a TPU gathers).
    """
    if preselected:
        if tuple(limbs_step.shape[1:3]) != (len(nz), l):
            raise ValueError(f"preselected limbs {tuple(limbs_step.shape)} "
                             f"do not hold {len(nz)} blocks of {l} rows")
        sel = limbs_step
    else:
        sel = select_nz_limbs(limbs_step, nz, l)
    return expand_karatsuba_step(
        sel.reshape(4, len(nz) * l, 1, sel.shape[-1]), t, plan)


def _digit_combos(digits: torch.Tensor, plan: KaratsubaPlan, t: int) -> list:
    """digits: int32[B, P, N] -> per leaf, int8[S_leaf, B, L*P*T] with entry
    j at columns [j*P*T, (j+1)*P*T), (p, u) order within."""
    b, p, n = digits.shape
    m = n // t
    dblk = digits.reshape(b, p, m, t).permute(0, 2, 1, 3).reshape(b, m, p * t)
    out = []
    for lf in plan.leaves:
        combos = []
        for entry in lf.entries:
            comb = dblk[:, entry[0]]
            for d in entry[1:]:
                comb = comb + dblk[:, d]
            combos.append(comb)
        v = torch.cat(combos, dim=-1)  # [B, L*P*T] int32
        if lf.d_shifts == (0,):
            out.append(v.to(torch.int8)[None])
        else:
            lo = ((v & 127) ^ 64) - 64
            hi = (v - lo) >> 7
            out.append(torch.stack([lo.to(torch.int8), hi.to(torch.int8)]))
    return out


def karatsuba_delta(digits: torch.Tensor, e_step: torch.Tensor, t: int,
                    plan: KaratsubaPlan) -> torch.Tensor:
    """CMUX delta = sum_p conv(digits[:, p], key[p, :]) through the plan.

    digits: int32[B, P, N] from `decompose`; e_step: int8[total_rows*P*T,
    K*4*T] from `bake_karatsuba`. Returns int32[B, K, N].
    """
    b, p, n = digits.shape
    m = n // t
    cols = e_step.shape[-1]
    k_out = cols // (4 * t)
    pt = p * t

    d_ops = _digit_combos(digits, plan, t)
    # folded accumulator: C_o - C_{o+M}, accumulated at o mod M
    acc = torch.zeros((b, m, cols), dtype=torch.int32, device=digits.device)
    for lf, d_op in zip(plan.leaves, d_ops):
        L = lf.length
        base_row = lf.row_offset * pt
        for o in range(2 * L - 1):
            i0, i1 = max(0, o - L + 1), min(L - 1, o)
            lhs = d_op[:, :, i0 * pt: (i1 + 1) * pt]
            r0 = base_row + (L - 1 - o + i0) * pt
            rhs = e_step[r0: r0 + (i1 - i0 + 1) * pt]
            prod = i8_matmul(lhs.reshape(-1, lhs.shape[-1]), rhs)
            prod = prod.reshape(len(lf.d_shifts), b, cols)
            rec = prod[0] << lf.d_shifts[0]
            for s in range(1, len(lf.d_shifts)):
                rec = rec + (prod[s] << lf.d_shifts[s])
            for off, sgn in lf.contribs:
                pos = off + o
                if pos >= 2 * m - 1:
                    continue  # C has length 2M-1
                sgn_f = sgn if pos < m else -sgn
                if sgn_f == 1:
                    acc[:, pos % m] += rec
                else:
                    acc[:, pos % m] -= rec
    accr = acc.reshape(b, m, k_out, 4, t)
    out = accr[:, :, :, 0, :].clone()
    for limb in range(1, 4):
        out += accr[:, :, :, limb, :] << (8 * limb)
    return out.permute(0, 2, 1, 3).reshape(b, k_out, n)
