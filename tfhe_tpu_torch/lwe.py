"""LWE over the torus, batched struct-of-arrays style.

Counterpart of `tfhe_tpu/lwe.py`. A batch of ciphertexts is one
`LweSample` of tensors: `a: int32[..., n]`, `b: int32[...]`, and the
advisory noise variance `cv: float32[...]`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .numeric import (dtot32, rand_gaussian_float, rand_uniform_bool,
                      rand_uniform_torus32)


class LweSample(NamedTuple):
    """Batch of LWE ciphertexts: b = <a, s> + message + noise."""

    a: torch.Tensor
    b: torch.Tensor
    cv: torch.Tensor

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.a.shape[:-1])

    def __add__(self, other: "LweSample") -> "LweSample":
        return LweSample(self.a + other.a, self.b + other.b, self.cv + other.cv)

    def __sub__(self, other: "LweSample") -> "LweSample":
        return LweSample(self.a - other.a, self.b - other.b, self.cv + other.cv)

    def __neg__(self) -> "LweSample":
        return LweSample(-self.a, -self.b, self.cv)

    def __mul__(self, y: int) -> "LweSample":
        return LweSample(self.a * y, self.b * y, self.cv * float(y) ** 2)

    __rmul__ = __mul__


def lwe_key_gen(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniform binary key s in {0,1}^n, int32."""
    return rand_uniform_bool(generator, (n,))


def lwe_encrypt_core(message, a: torch.Tensor, noise_t32,
                     key: torch.Tensor) -> LweSample:
    """Encryption with injected randomness: b = message + noise + <a, s>,
    int32 wrapping. message/noise broadcast over the batch; a: int32[..., n];
    key: int32[n]."""
    b = torch.as_tensor(message, dtype=torch.int32, device=a.device) \
        + torch.as_tensor(noise_t32, dtype=torch.int32, device=a.device)
    b = b + torch.sum(a * key, dim=-1, dtype=torch.int32)
    return LweSample(a, b, torch.zeros(b.shape, dtype=torch.float32,
                                       device=a.device))


def lwe_encrypt(generator: torch.Generator, message: torch.Tensor,
                alpha: float, key: torch.Tensor) -> LweSample:
    """b = message + N(0, alpha^2) + <a, s> with fresh uniform a.
    message: int32 tensor on the generator's device."""
    n = key.shape[-1]
    a = rand_uniform_torus32(generator, tuple(message.shape) + (n,))
    noise = dtot32(rand_gaussian_float(generator, alpha, message.shape))
    sample = lwe_encrypt_core(message, a, noise, key)
    return sample._replace(cv=torch.full(sample.b.shape, alpha**2,
                                         dtype=torch.float32,
                                         device=a.device))


def lwe_phase(sample: LweSample, key: torch.Tensor) -> torch.Tensor:
    """phi = b - <a, s> (int32 wrapping)."""
    return sample.b - torch.sum(sample.a * key, dim=-1, dtype=torch.int32)


def lwe_noiseless_trivial(mu, n: int, batch_shape=(),
                          device: torch.device | str = "cpu") -> LweSample:
    """(0, mu): a trivial sample anyone can decrypt."""
    batch_shape = tuple(batch_shape)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device)
    return LweSample(
        torch.zeros(batch_shape + (n,), dtype=torch.int32, device=device),
        mu.expand(batch_shape).clone(),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )
