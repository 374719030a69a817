"""TGSW encryption and the signed gadget decomposition.

Counterpart of `tfhe_tpu/tgsw.py`: encryption, the decomposition, and the
external product against a prepared (`tgsw_extern_mul_prepared`, what a
compact key falls back on) or a coefficient-domain TGSW operand
(`tgsw_extern_mul`). A TGSW
sample is one int32 tensor [..., l, k+1, k+1, N] (decomposition row, TLWE
row, polynomial index, coefficient).
"""

from __future__ import annotations

import functools

import torch

from .ops import conv
from .tlwe import TLweSample, tlwe_encrypt_zero, tlwe_encrypt_zero_core


def _wrap_i32(v: int) -> int:
    """A Python int reduced mod 2^32 into the int32 range."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


@functools.lru_cache(maxsize=None)
def gadget_values(decomp_length: int, log2_base: int) -> tuple:
    """Nonzero gadget entries 2^(32 - (i+1)*b) as wrapped int32 Python ints."""
    return tuple(_wrap_i32(1 << (32 - (i + 1) * log2_base))
                 for i in range(decomp_length))


@functools.lru_cache(maxsize=None)
def decomp_offset(decomp_length: int, log2_base: int,
                  balanced: bool = False) -> int:
    """offset = (B/2) * sum(gadget) as a wrapped int32.

    With balanced=True a half-ulp 2^(31 - l*b) is folded in, which turns the
    decomposition's truncation into round-to-nearest; decompose(0) == 0
    still holds.
    """
    total = sum(1 << (32 - (i + 1) * log2_base)
                for i in range(decomp_length)) * (1 << (log2_base - 1))
    if balanced and decomp_length * log2_base < 32:
        total += 1 << (31 - decomp_length * log2_base)
    return _wrap_i32(total)


def decompose(poly: torch.Tensor, decomp_length: int, log2_base: int,
              balanced: bool = False) -> torch.Tensor:
    """Signed base-2^b digits: int32[..., N] -> int32[..., l, N], digits in
    [-B/2, B/2), with sum_j digit_j * gadget_j == poly rounded to l*b bits
    (mod 2^32). decompose(0) == 0 in both gadget modes."""
    offset = decomp_offset(decomp_length, log2_base, balanced)
    mask = (1 << log2_base) - 1
    half = 1 << (log2_base - 1)
    shifted = poly.to(torch.int32) + offset
    shifts = torch.tensor(
        [32 - (p + 1) * log2_base for p in range(decomp_length)],
        dtype=torch.int32, device=poly.device)
    digits = (shifted.unsqueeze(-2) >> shifts[:, None]) & mask
    return digits - half


def tgsw_add_gadget_times_message(samples: torch.Tensor, message,
                                  decomp_length: int,
                                  log2_base: int) -> torch.Tensor:
    """samples: int32[..., l, k+1, k+1, N]; adds message * gadget[i] to the
    constant coefficient of the diagonal blocks (i, j, j)."""
    kp1 = samples.shape[-3]
    dev = samples.device
    g = torch.tensor(gadget_values(decomp_length, log2_base),
                     dtype=torch.int32, device=dev)
    message = torch.as_tensor(message, dtype=torch.int32, device=dev)
    eye = torch.eye(kp1, dtype=torch.int32, device=dev)
    out = samples.clone()
    bump = message[..., None, None, None] * g[:, None, None] * eye  # [..., l, K, K]
    out[..., 0] += bump
    return out


def tgsw_encrypt_zero_core(a_parts: torch.Tensor, noises_t32: torch.Tensor,
                           key: torch.Tensor) -> torch.Tensor:
    """l*(k+1) homogeneous TLWE encryptions with injected randomness.

    a_parts: int32[..., l, k+1, k, N]; noises_t32: int32[..., l, k+1, N];
    key: int32[k, N]. Returns int32[..., l, k+1, k+1, N].
    """
    return tlwe_encrypt_zero_core(a_parts, noises_t32, key).a


def tgsw_encrypt(generator: torch.Generator, message, alpha: float,
                 key: torch.Tensor, decomp_length: int, log2_base: int,
                 batch_shape=()) -> torch.Tensor:
    """Fresh TGSW encryption(s) of small int message(s), broadcastable to
    batch_shape. Returns int32[..., l, k+1, k+1, N]."""
    k = key.shape[0]
    zero = tlwe_encrypt_zero(
        generator, alpha, key, tuple(batch_shape) + (decomp_length, k + 1)).a
    return tgsw_add_gadget_times_message(zero, message, decomp_length,
                                         log2_base)


def prepare_tgsw(gsw: torch.Tensor, decomp_length: int,
                 log2_base: int) -> torch.Tensor:
    """Reorder and limb-split a TGSW sample for the external product:
    int32[..., l(i), k+1(j), k+1(c), N] -> int8[..., 4, (k+1)*l, k+1, 2N],
    the contraction dim ordered j-major (the decomposition's layout)."""
    moved = torch.movedim(gsw, -4, -3)  # [..., k+1(j), l(i), k+1(c), N]
    shape = moved.shape
    flat = moved.reshape(shape[:-4] + (shape[-4] * shape[-3],) + shape[-2:])
    return conv.prepare_shared_torus(flat)


def tgsw_extern_mul_prepared(accum: TLweSample, gsw_limbs: torch.Tensor,
                             decomp_length: int, log2_base: int,
                             balanced: bool = False) -> TLweSample:
    """External product gsw (x) accum against a prepared TGSW operand.

    accum.a: int32[B, k+1, N] (exactly one batch dim); gsw_limbs:
    int8[4, P, k+1, 2N] from `prepare_tgsw`.
    out[c] = sum_{j,i} conv(digits[j, i], gsw[i, j, c]).
    """
    bsz, kp1, n = accum.a.shape
    digits = decompose(accum.a, decomp_length, log2_base, balanced)
    digits = digits.reshape(bsz, kp1 * decomp_length, n)  # j-major
    out = conv.poly_mul_prepared(digits, gsw_limbs, log2_base - 1)
    return TLweSample(out, accum.cv)


def tgsw_extern_mul(accum: TLweSample, gsw: torch.Tensor, decomp_length: int,
                    log2_base: int, balanced: bool = False) -> TLweSample:
    """External product against a coefficient-domain TGSW sample
    gsw: int32[l, k+1, k+1, N]; accum batched [B, k+1, N]."""
    return tgsw_extern_mul_prepared(
        accum, prepare_tgsw(gsw, decomp_length, log2_base), decomp_length,
        log2_base, balanced)
