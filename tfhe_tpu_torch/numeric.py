"""Torus numerics: Torus32 words, message encode/decode, samplers.

Counterpart of `tfhe_tpu/numeric.py`. The torus value x in [-1/2, 1/2) is the
int32 word round(x * 2^32); int32 wraparound is arithmetic mod 2^32.

Every random draw takes an explicit `torch.Generator` and lands on that
generator's device. Torch and JAX draw different numbers from the same
seed, so equality tests inject the same draws through the `*_core`
functions instead.
"""

from __future__ import annotations

import torch

# 2^32 as a float; used only to scale unit-range floats into torus words.
_TWO32 = float(2**32)


def encode_message(mu: int, message_space: int) -> int:
    """Phase of integer message `mu` in a power-of-2 message space:
    mu << (32 - log2(ms)) as a wrapped int32 (a Python int)."""
    log2_ms = message_space.bit_length() - 1
    if 1 << log2_ms != message_space:
        raise ValueError("message_space must be a power of 2")
    v = (mu << (32 - log2_ms)) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def decode_message(phase: torch.Tensor, message_space: int) -> torch.Tensor:
    """Round a torus phase to the nearest message in [-ms/2, ms/2):
    (phase + 2^(32-log2ms-1)) >> (32-log2ms), wrapping add and arithmetic
    shift. Also the bootstrap's modulus switch to 2N."""
    log2_ms = message_space.bit_length() - 1
    if 1 << log2_ms != message_space:
        raise ValueError("message_space must be a power of 2")
    half = 1 << (32 - log2_ms - 1)
    return (phase.to(torch.int32) + half) >> (32 - log2_ms)


def dtot32(d: torch.Tensor) -> torch.Tensor:
    """float in [-0.5, 0.5) -> Torus32 = trunc(d * 2^32), in float32."""
    return torch.trunc(d.to(torch.float32) * _TWO32).to(torch.int32)


def rand_uniform_bool(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform {0, 1} as int32."""
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32,
                         generator=generator, device=generator.device)


def rand_uniform_torus32(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform over all 2^32 torus words."""
    return torch.randint(-(2**31), 2**31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=generator.device)


def rand_gaussian_float(generator: torch.Generator, sigma: float,
                        shape) -> torch.Tensor:
    """N(0, sigma^2) float32 values."""
    return torch.randn(tuple(shape), dtype=torch.float32, generator=generator,
                       device=generator.device) * sigma
