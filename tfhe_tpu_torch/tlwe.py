"""TLWE (module-LWE over the torus), batched struct-of-arrays style.

Counterpart of `tfhe_tpu/tlwe.py`. A TLWE sample is one int32 tensor
`a[..., k+1, N]`: the k mask polynomials, then the body.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import polynomial
from .lwe import LweSample
from .numeric import (dtot32, rand_gaussian_float, rand_uniform_bool,
                      rand_uniform_torus32)
from .ops import conv


class TLweSample(NamedTuple):
    """Batch of TLWE ciphertexts: a: int32[..., k+1, N]; cv: float32[...]."""

    a: torch.Tensor
    cv: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.a[..., :-1, :]

    @property
    def body(self) -> torch.Tensor:
        return self.a[..., -1, :]

    def __add__(self, other: "TLweSample") -> "TLweSample":
        return TLweSample(self.a + other.a, self.cv + other.cv)

    def __sub__(self, other: "TLweSample") -> "TLweSample":
        return TLweSample(self.a - other.a, self.cv + other.cv)


def tlwe_key_gen(generator: torch.Generator, n: int,
                 mask_size: int) -> torch.Tensor:
    """k uniform binary polynomials, int32[k, N]."""
    return rand_uniform_bool(generator, (mask_size, n))


def extract_lwe_key(tlwe_key: torch.Tensor) -> torch.Tensor:
    """The ring key's coefficients as an LWE key of size k*N."""
    return tlwe_key.reshape(-1)


def tlwe_extract_sample(sample: TLweSample) -> LweSample:
    """The constant coefficient as a (k*N)-dim LWE sample: a = the reversed
    mask polynomials, concatenated; b = body[0]."""
    rev = polynomial.reverse_polynomial(sample.mask)  # [..., k, N]
    a = rev.reshape(rev.shape[:-2] + (rev.shape[-2] * rev.shape[-1],))
    b = sample.body[..., 0]
    return LweSample(a, b, sample.cv.expand(b.shape))


def tlwe_encrypt_zero_core(a_part: torch.Tensor, noise_t32: torch.Tensor,
                           key: torch.Tensor) -> TLweSample:
    """Homogeneous encryption with injected randomness.

    a_part: int32[..., k, N] uniform masks; noise_t32: int32[..., N];
    key: int32[k, N] binary. body = noise + sum_i conv(s_i, a_i) mod 2^32.
    """
    batch_shape = a_part.shape[:-2]
    k, n = key.shape
    flat = a_part.reshape(-1, k, n)
    body = conv.poly_mul_batched_torus(flat, key).reshape(batch_shape + (n,))
    body = body + noise_t32
    full = torch.cat([a_part, body.unsqueeze(-2)], dim=-2)
    return TLweSample(full, torch.zeros(batch_shape, dtype=torch.float32,
                                        device=a_part.device))


def tlwe_encrypt_zero(generator: torch.Generator, alpha: float,
                      key: torch.Tensor, batch_shape=()) -> TLweSample:
    """Fresh homogeneous encryption(s) of zero."""
    batch_shape = tuple(batch_shape)
    k, n = key.shape
    a_part = rand_uniform_torus32(generator, batch_shape + (k, n))
    noise = dtot32(rand_gaussian_float(generator, alpha, batch_shape + (n,)))
    sample = tlwe_encrypt_zero_core(a_part, noise, key)
    return sample._replace(cv=torch.full(batch_shape, alpha**2,
                                         dtype=torch.float32,
                                         device=key.device))


def tlwe_noiseless_trivial(mu: torch.Tensor, mask_size: int) -> TLweSample:
    """(0, mu) for a torus polynomial mu[..., N]."""
    zeros = torch.zeros(mu.shape[:-1] + (mask_size,) + mu.shape[-1:],
                        dtype=torch.int32, device=mu.device)
    full = torch.cat([zeros, mu.to(torch.int32).unsqueeze(-2)], dim=-2)
    return TLweSample(full, torch.zeros(mu.shape[:-1], dtype=torch.float32,
                                        device=mu.device))


def tlwe_mul_by_monomial(sample: TLweSample, shift) -> TLweSample:
    """All k+1 polynomials times X^shift; shift may be batched like the
    sample's batch dims."""
    shift = torch.as_tensor(shift, dtype=torch.int32, device=sample.a.device)
    return TLweSample(polynomial.mul_by_monomial(sample.a, shift[..., None]),
                      sample.cv)
