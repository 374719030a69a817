"""Negacyclic polynomial ring Z_2^32[x]/(x^N + 1), batched over leading dims.

Counterpart of `tfhe_tpu/polynomial.py`. Polynomials are int32 tensors of
shape [..., N], coefficient c[i] of x^i at index i.
"""

from __future__ import annotations

import torch


def mul_by_monomial(p: torch.Tensor, shift) -> torch.Tensor:
    """p * x^shift mod (x^N + 1), exact for any integer shift (negative or
    >= 2N included).

    Since x^N = -1 the coefficients are 2N-periodic with a sign flip every
    N, so out[r] = doubled[(r - s) mod 2N] with doubled = [p, -p] and
    s = shift mod 2N. `shift` is a Python int or an integer tensor
    broadcastable to p.shape[:-1].
    """
    n = p.shape[-1]
    doubled = torch.cat([p, -p], dim=-1)  # [..., 2N]
    s = torch.remainder(torch.as_tensor(shift, device=p.device), 2 * n)
    r = torch.arange(n, device=p.device)
    idx = torch.remainder(r - s.to(torch.int64)[..., None], 2 * n)
    idx = idx.expand(p.shape[:-1] + (n,))
    return torch.gather(doubled, -1, idx)


def reverse_polynomial(p: torch.Tensor) -> torch.Tensor:
    """p(x) -> p(1/x) mod (x^N + 1): out[0] = p[0], out[r] = -p[N-r]."""
    rolled = torch.roll(torch.flip(p, dims=(-1,)), 1, dims=-1)
    sign = torch.full((p.shape[-1],), -1, dtype=p.dtype, device=p.device)
    sign[0] = 1
    return rolled * sign


def constant_polynomial(value, n: int,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """The polynomial with every coefficient `value`, int32[n] (the
    bootstrap's test vector)."""
    return torch.full((n,), value, dtype=torch.int32, device=device)
