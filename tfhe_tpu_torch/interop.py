"""Converters from numpy arrays of the reference's key and ciphertext fields
into the port's types.

The inputs are `np.asarray` of the fields of `tfhe_tpu`'s `SecretKey`,
`CloudKey`, `BootstrapKey`, `KeyswitchKey`, `LweSample` and `TLweSample`,
so this module needs no JAX: the same keys and ciphertexts can run through
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import CloudKey, SecretKey
from .bootstrap import BootstrapKey
from .keyswitch import KeyswitchKey
from .lwe import LweSample
from .params import SchemeParameters
from .tlwe import TLweSample


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)  # a copy


def secret_key_from_numpy(params: SchemeParameters, key: np.ndarray,
                          device="cpu") -> SecretKey:
    return SecretKey(params, _t(key, torch.int32, device))


def bootstrap_key_from_numpy(*, baked: np.ndarray, decomp_length: int,
                             log2_base: int, polynomial_degree: int,
                             mask_size: int, block: int, depth: int = 0,
                             noise_stddev: float = 0.0,
                             balanced: bool = False, compact: bool = False,
                             device="cpu") -> BootstrapKey:
    """The fields of a reference BootstrapKey, in any of its three forms
    (Karatsuba-baked, dense depth-0, compact)."""
    return BootstrapKey(_t(baked, torch.int8, device), decomp_length,
                        log2_base, polynomial_degree, mask_size, block, depth,
                        float(noise_stddev), bool(balanced), bool(compact))


def keyswitch_key_from_numpy(*, table_limbs: np.ndarray, n_in: int,
                             n_out: int, decomp_length: int, log2_base: int,
                             noise_stddev: float = 0.0,
                             device="cpu") -> KeyswitchKey:
    return KeyswitchKey(_t(table_limbs, torch.int8, device), n_in, n_out,
                        decomp_length, log2_base, float(noise_stddev))


def cloud_key_from_numpy(params: SchemeParameters, bootstrap_key: dict,
                         keyswitch_key: dict, device="cpu") -> CloudKey:
    """bootstrap_key / keyswitch_key: the reference keys' fields by name,
    arrays as numpy."""
    return CloudKey(
        params,
        bootstrap_key_from_numpy(**bootstrap_key, device=device),
        keyswitch_key_from_numpy(**keyswitch_key, device=device))


def lwe_sample_from_numpy(a: np.ndarray, b: np.ndarray, cv: np.ndarray,
                          device="cpu") -> LweSample:
    return LweSample(_t(a, torch.int32, device), _t(b, torch.int32, device),
                     _t(cv, torch.float32, device))


def tlwe_sample_from_numpy(a: np.ndarray, cv: np.ndarray,
                           device="cpu") -> TLweSample:
    return TLweSample(_t(a, torch.int32, device),
                      _t(cv, torch.float32, device))
