"""Exact negacyclic products mod 2^32 as int8 limb contractions.

Counterpart of the parts of `tfhe_tpu/ops/conv.py` that the gate path
needs. A torus word splits into four balanced signed bytes, so a product
with a small operand becomes int8 x int8 -> int32 matrix products that are
exact, recombined with shifts mod 2^32.
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
