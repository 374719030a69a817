"""Public-key encryption for LWE ciphertexts.

Counterpart of `tfhe_tpu/public.py`. The public key is a batch of M
encryptions of zero; a bit is encrypted as a random binary subset-sum of
them plus the message on the body:

    ct = sum_i u_i * PK_i + (0, mu),   u uniform in {0,1}^M

so that untrusted writers can contribute ciphertexts. M >= (n+1)*32 +
2*lambda by the leftover hash lemma (`default_count`, lambda = 128); the
subset-sum noise has variance (M/2) * alpha^2, inside the gates' 1/16
margin at the shipped presets, so these ciphertexts feed gates directly.

The subset-sum is a [B, M] x [M, n+1] product of a 0/1 selector with
torus words mod 2^32. torch has no int32 matrix product on a CUDA card, so
the words are split into four balanced int8 limbs
(`ops/conv.py:split_torus_limbs`) and each limb goes through one exact
int8 product (`ops/conv.py:i8_matmul`): a limb sum is at most M * 128,
which int32 holds, and the limbs recombine mod 2^32 by shifts.

The public key is an `LweSample` batch, so it serializes, and with zero
messages it seeds down to M + 2 words (`make_public_key_seeded`).
"""

from __future__ import annotations

import dataclasses

import torch

from .api import SecretKey
from .compressed import SeededLweSample, _seeded_lwe, expand_lwe
from .lwe import LweSample, lwe_encrypt
from .numeric import encode_message, rand_uniform_bool
from .ops.conv import i8_matmul, split_torus_limbs
from .params import SchemeParameters


@dataclasses.dataclass(frozen=True)
class LwePublicKey:
    """M encryptions of zero under the secret LWE key."""

    params: SchemeParameters
    zeros: LweSample  # batch [M]

    @property
    def count(self) -> int:
        return self.zeros.b.shape[0]


def default_count(params: SchemeParameters, security: int = 128) -> int:
    """Leftover-hash-lemma mask count: (n+1)*log2(q) + 2*security."""
    return (params.lwe_size + 1) * 32 + 2 * security


def make_public_key(generator: torch.Generator, key: SecretKey,
                    count: int | None = None) -> LwePublicKey:
    """M fresh zero encryptions, on the generator's device."""
    m = default_count(key.params) if count is None else count
    zeros = torch.zeros((m,), dtype=torch.int32, device=generator.device)
    return LwePublicKey(key.params, lwe_encrypt(
        generator, zeros, key.params.lwe_noise_stddev, key.key))


@dataclasses.dataclass(frozen=True)
class SeededLwePublicKey:
    """Seeded wire form: the zero encryptions' bodies plus one mask seed."""

    params: SchemeParameters
    zeros: SeededLweSample


def make_public_key_seeded(generator: torch.Generator, key: SecretKey,
                           count: int | None = None) -> SeededLwePublicKey:
    """Seeded twin of `make_public_key`."""
    m = default_count(key.params) if count is None else count
    zeros = torch.zeros((m,), dtype=torch.int32, device=generator.device)
    return SeededLwePublicKey(key.params, _seeded_lwe(
        generator, zeros, key.params.lwe_noise_stddev, key.key))


def expand_public_key(pk: SeededLwePublicKey) -> LwePublicKey:
    return LwePublicKey(pk.params, expand_lwe(pk.zeros))


def _subset_sums(u: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """u: 0/1 [B, M]; words: int32 [M, C] -> int32 [B, C], the sums of the
    selected rows mod 2^32, as four exact int8 limb products."""
    u8 = u.to(torch.int8)
    limbs = split_torus_limbs(words)  # int8 [4, M, C]
    out = i8_matmul(u8, limbs[0])
    for j in range(1, 4):
        out += i8_matmul(u8, limbs[j]) << (8 * j)
    return out


def _encrypt_public_core(u: torch.Tensor, pk: LwePublicKey,
                         message: torch.Tensor) -> LweSample:
    """`encrypt_public` with the selector injected: u 0/1 [..., M] with
    message's batch shape."""
    mu = torch.where(message, encode_message(1, 8), encode_message(-1, 8))
    m = pk.count
    n = pk.zeros.a.shape[-1]
    words = torch.cat([pk.zeros.a, pk.zeros.b[:, None]], dim=1)  # [M, n+1]
    ab = _subset_sums(u.reshape(-1, m), words)
    ab = ab.reshape(tuple(message.shape) + (n + 1,))
    alpha2 = float(pk.params.lwe_noise_stddev) ** 2
    cv = torch.full(message.shape, 0.5 * m * alpha2, dtype=torch.float32,
                    device=ab.device)
    return LweSample(ab[..., :n], ab[..., n] + mu.to(torch.int32), cv)


def encrypt_public(generator: torch.Generator, pk: LwePublicKey,
                   message) -> LweSample:
    """Encrypt boolean bit(s) with the public key: mu = encode(+-1, 8), one
    uniform 0/1 selector row per bit, drawn from `generator` (on the key's
    device)."""
    message = torch.as_tensor(message, dtype=torch.bool,
                              device=pk.zeros.b.device)
    u = rand_uniform_bool(generator, tuple(message.shape) + (pk.count,))
    return _encrypt_public_core(u, pk, message)
