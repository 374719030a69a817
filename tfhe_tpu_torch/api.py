"""User-facing single-key API: keys, key pairs, bit encrypt/decrypt.

Counterpart of `tfhe_tpu/api.py`. Every function that draws randomness
takes a `torch.Generator`; keys and ciphertexts live on that generator's
device.
"""

from __future__ import annotations

import dataclasses

import torch

from .bootstrap import BootstrapKey, bootstrap_key_gen
from .keyswitch import KeyswitchKey, keyswitch_key_gen
from .lwe import LweSample, lwe_encrypt, lwe_key_gen, lwe_phase
from .numeric import encode_message
from .params import SchemeParameters, tfhe_parameters_80
from .tlwe import extract_lwe_key, tlwe_key_gen


@dataclasses.dataclass(frozen=True)
class SecretKey:
    """Client-side secret key: the binary LWE key, int32[n]."""

    params: SchemeParameters
    key: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CloudKey:
    """Server-side evaluation key: bootstrap and keyswitch keys."""

    params: SchemeParameters
    bootstrap_key: BootstrapKey
    keyswitch_key: KeyswitchKey


def make_secret_key(generator: torch.Generator,
                    params: SchemeParameters) -> SecretKey:
    return SecretKey(params, lwe_key_gen(generator, params.lwe_size))


def make_cloud_key(generator: torch.Generator,
                   secret_key: SecretKey) -> CloudKey:
    """Derive bootstrap and keyswitch keys from a fresh TLWE key that never
    leaves this function."""
    params = secret_key.params
    tlwe_key = tlwe_key_gen(generator, params.tlwe_polynomial_degree,
                            params.tlwe_mask_size)
    bs_key = bootstrap_key_gen(
        generator, params.bs_noise_stddev, secret_key.key, tlwe_key,
        params.bs_decomp_length, params.bs_log2_base,
        balanced=params.gadget_balanced)
    ks_key = keyswitch_key_gen(
        generator, params.ks_noise_stddev, extract_lwe_key(tlwe_key),
        secret_key.key, params.ks_decomp_length, params.ks_log2_base)
    return CloudKey(params, bs_key, ks_key)


def make_key_pair(generator: torch.Generator,
                  params: SchemeParameters | None = None):
    """(SecretKey, CloudKey) on the generator's device; defaults to the
    80-bit preset like the reference."""
    if params is None:
        params = tfhe_parameters_80()
    secret_key = make_secret_key(generator, params)
    return secret_key, make_cloud_key(generator, secret_key)


def encrypt(generator: torch.Generator, key: SecretKey,
            message: torch.Tensor) -> LweSample:
    """Encrypt boolean bit(s) as mu = encode(+-1, 8). message: bool[...]."""
    mu = torch.where(message.to(torch.bool),
                     encode_message(1, 8), encode_message(-1, 8))
    return lwe_encrypt(generator, mu.to(torch.int32),
                       key.params.lwe_noise_stddev, key.key)


def decrypt(key: SecretKey, sample: LweSample) -> torch.Tensor:
    """Decrypt to boolean(s): the sign of the phase."""
    return lwe_phase(sample, key.key) > 0
