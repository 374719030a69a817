"""Converters from numpy arrays of the reference's key and ciphertext fields
into the port's types.

The inputs are `np.asarray` of the fields of `tfhe_tpu`'s `SecretKey`,
`CloudKey`, `BootstrapKey`, `KeyswitchKey`, `LweSample` and `TLweSample`,
and of `tfhe_tpu.mk`'s `SharedKey`, `CloudKeyPart`, `MKBootstrapKey`,
`MKCloudKey` and `MKLweSample`, so this module needs no JAX: the same keys
and ciphertexts can run through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import CloudKey, SecretKey
from .bootstrap import BootstrapKey
from .keyswitch import KeyswitchKey
from .lwe import LweSample
from .mk.api import CloudKeyPart, MKCloudKey, SharedKey
from .mk.internals import MKBootstrapKey, MKLweSample, MKTGswUESample
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


# --- multi-key ---


def shared_key_from_numpy(params: SchemeParameters, a: np.ndarray,
                          device="cpu") -> SharedKey:
    return SharedKey(params, _t(a, torch.int32, device))


def cloud_key_part_from_numpy(params: SchemeParameters,
                              public_key: np.ndarray,
                              key_uni_enc: np.ndarray, keyswitch_key: dict,
                              device="cpu") -> CloudKeyPart:
    """key_uni_enc: the `cd` array [n, 6, l, N] of the party's
    uni-encryptions; keyswitch_key: the KeyswitchKey's fields by name."""
    return CloudKeyPart(
        params, _t(public_key, torch.int32, device),
        MKTGswUESample(_t(key_uni_enc, torch.int32, device)),
        keyswitch_key_from_numpy(**keyswitch_key, device=device))


def mk_bootstrap_key_from_numpy(*, limbs, parties: int, lwe_size: int,
                                decomp_length: int, log2_base: int,
                                polynomial_degree: int, block: int = 0,
                                noise_stddev: float = 0.0,
                                sparse: bool = False, balanced: bool = False,
                                device="cpu") -> MKBootstrapKey:
    """The fields of a reference MKBootstrapKey in any of its three forms:
    `limbs` is one array (dense prepared, or baked when block > 0) or, for a
    sparse-stored key, a sequence of one array per party."""
    if sparse:
        limbs_t = tuple(_t(part, torch.int8, device) for part in limbs)
    else:
        limbs_t = _t(limbs, torch.int8, device)
    return MKBootstrapKey(limbs_t, parties, lwe_size, decomp_length,
                          log2_base, polynomial_degree, block,
                          float(noise_stddev), bool(sparse), bool(balanced))


def mk_cloud_key_from_numpy(params: SchemeParameters, bootstrap_key: dict,
                            keyswitch_keys, device="cpu") -> MKCloudKey:
    """bootstrap_key: the MKBootstrapKey's fields by name; keyswitch_keys:
    one dict of KeyswitchKey fields per party."""
    bk = mk_bootstrap_key_from_numpy(**bootstrap_key, device=device)
    return MKCloudKey(
        params, bk.parties, bk,
        tuple(keyswitch_key_from_numpy(**ks, device=device)
              for ks in keyswitch_keys))


def mk_lwe_sample_from_numpy(a: np.ndarray, b: np.ndarray, cv: np.ndarray,
                             device="cpu") -> MKLweSample:
    return MKLweSample(_t(a, torch.int32, device), _t(b, torch.int32, device),
                       _t(cv, torch.float32, device))
