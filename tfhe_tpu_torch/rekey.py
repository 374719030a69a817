"""Proxy re-encryption: switch ciphertexts between users' keys on the
server.

Counterpart of `tfhe_tpu/rekey.py`. A re-keying key is an LWE keyswitch
key from one user's secret key to another's: the holder of `old`
authorizes the server to re-address their ciphertexts to `new` without
decrypting them. One hop adds one keyswitch of noise, so re-keyed
ciphertexts feed gates as bootstrap outputs do. The key is made by the
client (it needs `old.key`); the server sees only the table. The seeded
wire form is `compressed.keyswitch_key_gen_seeded`'s.
"""

from __future__ import annotations

import torch

from .api import SecretKey
from .compressed import SeededKeyswitchKey, keyswitch_key_gen_seeded
from .keyswitch import KeyswitchKey, keyswitch, keyswitch_key_gen
from .lwe import LweSample


def _check_params(old: SecretKey, new: SecretKey):
    if old.params != new.params:
        raise ValueError("re-keying needs matching parameters")


def make_rekey_key(generator: torch.Generator, old: SecretKey,
                   new: SecretKey) -> KeyswitchKey:
    """Keyswitch table Enc_new(s_old[i] * h / B^j): authorizes old -> new."""
    _check_params(old, new)
    p = old.params
    return keyswitch_key_gen(generator, p.ks_noise_stddev, old.key, new.key,
                             p.ks_decomp_length, p.ks_log2_base)


def make_rekey_key_seeded(generator: torch.Generator, old: SecretKey,
                          new: SecretKey) -> SeededKeyswitchKey:
    """The seeded wire form of the re-keying key."""
    _check_params(old, new)
    p = old.params
    return keyswitch_key_gen_seeded(generator, p.ks_noise_stddev, old.key,
                                    new.key, p.ks_decomp_length,
                                    p.ks_log2_base)


def rekey(key: KeyswitchKey, sample: LweSample) -> LweSample:
    """Re-address a ciphertext batch to the new key (no decryption)."""
    return keyswitch(key, sample)
