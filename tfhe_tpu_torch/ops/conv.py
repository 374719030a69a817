"""Exact negacyclic products mod 2^32 as int8 limb contractions.

Counterpart of `tfhe_tpu/ops/conv.py`: the limb splits, the prepared
(compact) product `poly_mul_prepared`, the dense block-Toeplitz bake with
its matmul and recombination, and the keygen products
`poly_mul_batched_torus`, `poly_mul_batched_small` and the multi-output
`poly_mul_batched_torus_multi` of the multi-key ceremony, and the pairwise
`negacyclic_mul` for low-volume paths. A torus word splits into four balanced signed
bytes, so a product with a small operand becomes int8 x int8 -> int32
matrix products that are exact, recombined with shifts mod 2^32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def i8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] x int8 [k, n] -> int32 [m, n] through
    `torch._int_mm` on either device.

    On CUDA `_int_mm` takes only m > 16 and k, n multiples of 8, so the
    operands are zero-padded to that and the result cut back; zero rows and
    columns add nothing to the sums.
    """
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(max(k, 16), 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n]


def recombine_limbs(prods: torch.Tensor) -> torch.Tensor:
    """int32 [m, 4*C], the products of a table's four int8 limbs laid out
    (limb, column) side by side, -> int32 [m, C]: the sum of limb << 8*limb,
    mod 2^32 (the keyswitch's table)."""
    m, cols = prods.shape
    prods = prods.reshape(m, 4, cols // 4)
    acc = prods[:, 0].clone()
    for limb in range(1, 4):
        acc += prods[:, limb] << (8 * limb)
    return acc


def negacyclic_toeplitz(t: torch.Tensor) -> torch.Tensor:
    """t: [..., N] int32 -> Toeplitz [..., N(m), N(r)], T[m, r] =
    doubled[(r - m) mod 2N] with doubled = [t, -t]. The negation happens in
    int32, before any narrowing."""
    n = t.shape[-1]
    doubled = torch.cat([t, -t], dim=-1)
    r = torch.arange(n, device=t.device)
    idx = torch.remainder(r[None, :] - r[:, None], 2 * n)  # [N(m), N(r)]
    return doubled[..., idx]


def split_torus_limbs(x: torch.Tensor) -> torch.Tensor:
    """int32 [...] -> int8 [4, ...] balanced limbs with
    x == sum_j limb_j * 2^(8j) (mod 2^32). The int8 cast wraps mod 256 into
    [-128, 128); subtracting it leaves an exact multiple of 256 for the
    arithmetic shift."""
    limbs = []
    cur = x
    for _ in range(3):
        b = cur.to(torch.int8)
        limbs.append(b)
        cur = (cur - b.to(torch.int32)) >> 8
    limbs.append(cur.to(torch.int8))  # the top limb only matters mod 2^8
    return torch.stack(limbs)


def split_small_limbs(d: torch.Tensor, bound_bits: int):
    """Split small signed ints |d| <= 2^bound_bits into int8 limbs.

    Returns (limbs int8[S, ...], shifts). Digits of a base up to 2^8 fit one
    limb; larger bases split base-16: d = hi*16 + lo with lo in [-8, 8).
    """
    if bound_bits <= 7:
        return d.to(torch.int8)[None], (0,)
    if bound_bits > 11:
        raise ValueError("small operand too large for two int8 limbs")
    lo = ((d & 15) ^ 8) - 8
    hi = (d - lo) >> 4
    return torch.stack([lo.to(torch.int8), hi.to(torch.int8)]), (0, 4)


def prepare_shared_torus(t_shared: torch.Tensor) -> torch.Tensor:
    """[..., P, K, N] int32 -> [..., 4, P, K, 2N] int8: the limb split of the
    doubled [t, -t] words (negated in int32 before the split, where
    -(-2^31) wraps correctly)."""
    doubled = torch.cat([t_shared, -t_shared], dim=-1)
    limbs = split_torus_limbs(doubled)  # [4, ..., P, K, 2N]
    return torch.movedim(limbs, 0, -4)


def poly_mul_batched_torus(a_batch: torch.Tensor,
                           s_shared: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_p negacyclic_conv(s_shared[p], a_batch[b, p]) mod 2^32.

    a_batch: [B, P, N] int32 torus polynomials; s_shared: [P, N] small ints
    that fit int8 (the binary key). Returns [B, N] int32. The keygen product.
    """
    bsz, p, n = a_batch.shape
    toep = negacyclic_toeplitz(s_shared.to(torch.int32)).to(torch.int8)
    toep = toep.reshape(p * n, n)
    a_limbs = split_torus_limbs(a_batch)  # [4, B, P, N]
    prods = i8_matmul(a_limbs.reshape(4 * bsz, p * n), toep).reshape(4, bsz, n)
    out = prods[0].clone()
    for j in range(1, 4):
        out += prods[j] << (8 * j)
    return out


def poly_mul_prepared(digits: torch.Tensor, t_limbs_doubled: torch.Tensor,
                      small_bound_bits: int,
                      max_toeplitz_bytes: int = 256 * 2**20) -> torch.Tensor:
    """out[b, k] = sum_p negacyclic_conv(digits[b, p], t[p, k]) mod 2^32.

    digits: int32[B, P, N], |digits| <= 2^small_bound_bits;
    t_limbs_doubled: int8[4, P, K, 2N] from `prepare_shared_torus`. Returns
    int32[B, K, N]. The torus side becomes a limb Toeplitz [P*N, K*4*N]
    shared by the batch, gathered at call time; above `max_toeplitz_bytes`
    the contraction is chunked over P (int32 sums commute exactly).
    """
    bsz, p, n = digits.shape
    k = t_limbs_doubled.shape[-2]
    d_limbs, d_shifts = split_small_limbs(digits, small_bound_bits)
    s = d_limbs.shape[0]
    full_bytes = 4 * p * k * n * n
    p_chunk = p
    if full_bytes > max_toeplitz_bytes:
        p_chunk = max(1, p * max_toeplitz_bytes // full_bytes)
    r = torch.arange(n, device=digits.device)
    idx = torch.remainder(r[None, :] - r[:, None], 2 * n)  # [N(m), N(r)]
    prods = torch.zeros((s * bsz, k * 4 * n), dtype=torch.int32,
                        device=digits.device)
    for p0 in range(0, p, p_chunk):
        p1 = min(p, p0 + p_chunk)
        toep = t_limbs_doubled[:, p0:p1][..., idx]  # [4, pc, K, N(m), N(r)]
        toep = toep.permute(1, 3, 2, 0, 4).reshape((p1 - p0) * n, k * 4 * n)
        lhs = d_limbs[:, :, p0:p1].reshape(s * bsz, (p1 - p0) * n)
        prods += i8_matmul(lhs, toep)
    prods = prods.reshape(s, bsz, k, 4, n)
    out = torch.zeros((bsz, k, n), dtype=torch.int32, device=digits.device)
    for si in range(s):
        for j in range(4):
            shift = d_shifts[si] + 8 * j
            if shift < 32:
                out += prods[si, :, :, j, :] << shift
    return out


def poly_mul_batched_small(digits: torch.Tensor, t_shared: torch.Tensor,
                           small_bound_bits: int) -> torch.Tensor:
    """One-shot form of `poly_mul_prepared` (limb preparation inlined).

    digits: int32[B, P, N] small ints; t_shared: int32[P, K, N] torus
    polynomials shared by the batch. Returns int32[B, K, N].
    """
    return poly_mul_prepared(digits, prepare_shared_torus(t_shared),
                             small_bound_bits)


def poly_mul_batched_torus_multi(a_batch: torch.Tensor,
                                 s_shared: torch.Tensor) -> torch.Tensor:
    """out[b, k] = sum_p negacyclic_conv(s_shared[k, p], a_batch[b, p])
    mod 2^32.

    a_batch: int32[B, P, N] torus polynomials; s_shared: int32[K, P, N] small
    ints that fit int8, shared by the batch. Returns int32[B, K, N]: one
    Toeplitz [P*N, K*N] of the small operand serves every batch element and
    every output k (the multi-key expansion's contraction).
    """
    bsz, p, n = a_batch.shape
    k = s_shared.shape[0]
    toep = negacyclic_toeplitz(s_shared.to(torch.int32)).to(torch.int8)
    toep = toep.permute(1, 2, 0, 3).reshape(p * n, k * n)  # [K,P,N,N] ->
    a_limbs = split_torus_limbs(a_batch)  # [4, B, P, N]
    prods = i8_matmul(a_limbs.reshape(4 * bsz, p * n), toep)
    prods = prods.reshape(4, bsz, k, n)
    out = prods[0].clone()
    for j in range(1, 4):
        out += prods[j] << (8 * j)
    return out


def _block_toeplitz_index(n: int, t: int, device) -> torch.Tensor:
    """[2M, T(u), T(w)] index (d*T + w - u) mod 2N into the doubled words,
    in the PERMUTED storage order: entry j holds block shift
    d = (M - 1 - j) mod 2M. Digit block i of output block o then pairs with
    entry (M-1-o) + i, so each output block reads one contiguous window
    that never wraps."""
    m = n // t
    j = torch.arange(2 * m, device=device)
    d = torch.remainder(m - 1 - j, 2 * m)[:, None, None]
    u = torch.arange(t, device=device)[None, :, None]
    w = torch.arange(t, device=device)[None, None, :]
    return torch.remainder(d * t + w - u, 2 * n)


def bake_block_toeplitz(limbs_doubled: torch.Tensor, t: int,
                        chunk: int = 16) -> torch.Tensor:
    """Pre-gather the blocked Toeplitz form of prepared torus operands.

    limbs_doubled: int8[n_steps, 4, P, K, 2N] (`prepare_shared_torus`).
    Returns E: int8[n_steps, 2M*P*T, K*4*T], rows (block entry, p, u),
    columns (k, limb, w), block entries in the permuted order of
    `_block_toeplitz_index`. Built `chunk` steps at a time into one
    preallocated tensor, so the gather's temporaries stay small next to
    the multi-GB result.
    """
    steps, _, p, k, n2 = limbs_doubled.shape
    n = n2 // 2
    if n % t:
        raise ValueError(f"block {t} does not divide N={n}")
    m2 = 2 * n // t
    idx = _block_toeplitz_index(n, t, limbs_doubled.device).reshape(-1)
    out = torch.empty((steps, m2 * p * t, k * 4 * t), dtype=torch.int8,
                      device=limbs_doubled.device)
    for s0 in range(0, steps, chunk):
        limbs = limbs_doubled[s0:s0 + chunk]
        e = limbs[..., idx].reshape(limbs.shape[:-1] + (m2, t, t))
        e = e.permute(0, 4, 2, 5, 3, 1, 6)  # [c, 2M, P, T(u), K, 4, T(w)]
        out[s0:s0 + chunk] = e.reshape(limbs.shape[0], m2 * p * t, k * 4 * t)
    return out


def block_toeplitz_matmul(d_limbs: torch.Tensor, e_step: torch.Tensor,
                          t: int) -> torch.Tensor:
    """Negacyclic product against one step of a `bake_block_toeplitz` key.

    d_limbs: int8[S, B, P, N] digit limbs; e_step: int8[2M*P*T, K*4*T].
    Returns int32[S, B, M, K*4*T]: output block o at row o, columns
    (k, limb, w). out[o] = sum_i D[i] @ E[shift (o - i) mod 2M]; per block
    shift the valid (i, o) pairs are one contiguous range, so the sum is
    2M-1 matmuls with exactly M^2 block products.
    """
    s, bsz, p, n = d_limbs.shape
    m = n // t
    m2 = 2 * m
    cols = e_step.shape[-1]
    e_blocks = e_step.reshape(m2, p * t, cols)
    dl = d_limbs.reshape(s, bsz, p, m, t).permute(0, 1, 3, 2, 4)
    dl = dl.reshape(s * bsz, m, p * t)
    out = torch.zeros((s * bsz, m, cols), dtype=torch.int32,
                      device=d_limbs.device)
    for d in range(m2):
        e_d = e_blocks[(m - 1 - d) % m2]  # the permuted storage order
        if d < m:
            vo = m - d  # o in [d, m), i = o - d in [0, vo)
            lhs = dl[:, 0:vo].reshape(s * bsz * vo, p * t)
            out[:, d:m] += i8_matmul(lhs, e_d).reshape(s * bsz, vo, cols)
        elif d > m:
            c = d - m  # o in [0, c), i = o - d + 2m in [2m - d, m)
            lhs = dl[:, 2 * m - d:m].reshape(s * bsz * c, p * t)
            out[:, 0:c] += i8_matmul(lhs, e_d).reshape(s * bsz, c, cols)
    return out.reshape(s, bsz, m, cols)


def recombine_block_prods(prods: torch.Tensor, k_out: int,
                          d_shifts) -> torch.Tensor:
    """Recombine limb-plane partial products into int32 polynomials.

    prods: int32[S, B, M, K*4*T] from `block_toeplitz_matmul`; d_shifts:
    the digit-limb shifts of `split_small_limbs`. Returns int32[B, K, N].
    """
    s, bsz, m, cols = prods.shape
    t = cols // (k_out * 4)
    pr = prods.reshape(s, bsz, m, k_out, 4, t)
    acc = torch.zeros((bsz, k_out, m, t), dtype=torch.int32,
                      device=prods.device)
    for si in range(s):
        for j in range(4):
            shift = int(d_shifts[si]) + 8 * j
            if shift < 32:
                acc += pr[si, :, :, :, j, :].transpose(1, 2) << shift
    return acc.reshape(bsz, k_out, m * t)


def negacyclic_mul(x_small: torch.Tensor, y_torus: torch.Tensor) -> torch.Tensor:
    """Pairwise exact negacyclic product, broadcasting leading dims.

    x_small: [..., N] int32 (the small operand), y_torus: [..., N] int32.
    Materialises the Toeplitz of y ([..., N, N] int32) and sums the int32
    products with wraparound (elementwise, so on any device), so reserve
    it for low-volume paths (key ceremonies, tests).
    """
    toep = negacyclic_toeplitz(y_torus.to(torch.int32))  # [..., N(m), N(r)]
    return torch.sum(x_small.to(torch.int32).unsqueeze(-1) * toep, dim=-2,
                     dtype=torch.int32)
