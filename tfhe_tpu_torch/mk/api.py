"""Multi-key TFHE user API: parameter presets, key ceremony, encrypt/decrypt.

Counterpart of `tfhe_tpu/mk/api.py`. The trust boundaries are the
ceremony's: the server makes a SharedKey; each party derives a CloudKeyPart
from its SecretKey and the SharedKey; the server assembles the MKCloudKey
(the expansion); joint encryption and decryption need all parties' secret
keys, and `mk_partial_decrypt` + `mk_combine_shares` decrypt without
gathering them. Every function that draws randomness takes a
`torch.Generator`; what it makes lives on that generator's device.

The presets are plain data, re-stated here; a test pins every field equal
to the reference's, where the reasoning behind each (noise margins) lives.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..api import SecretKey
from ..keyswitch import KeyswitchKey, keyswitch_key_gen
from ..numeric import (
    dtot32,
    encode_message,
    rand_gaussian_float,
    rand_uniform_torus32,
)
from ..params import SchemeParameters
from ..tlwe import tlwe_key_gen
from .internals import (
    MKBootstrapKey,
    MKLweSample,
    MKTGswUESample,
    mk_bootstrap_key,
    mk_lwe_phase,
    mk_tgsw_encrypt,
    public_key_gen,
    shared_key_gen,
)


def _mk_parameters(max_parties: int, bs_decomp_length: int,
                   bs_log2_base: int) -> SchemeParameters:
    """The production presets share everything but the bootstrap gadget."""
    return SchemeParameters(
        lwe_size=500, lwe_noise_stddev=0.012467,
        tlwe_polynomial_degree=1024, tlwe_mask_size=1,
        bs_decomp_length=bs_decomp_length, bs_log2_base=bs_log2_base,
        bs_noise_stddev=3.29e-10,
        ks_decomp_length=8, ks_log2_base=2, ks_noise_stddev=2.44e-5,
        max_parties=max_parties,
    )


def mktfhe_parameters_2party() -> SchemeParameters:
    """The reference-fidelity 2-party preset (l = 4, b = 7); it carries an
    intrinsic ~1.5% per-gate failure rate. Prefer
    `mktfhe_parameters_2party_lownoise`."""
    return _mk_parameters(2, 4, 7)


def mktfhe_parameters_2party_lownoise() -> SchemeParameters:
    """2 parties with the 4-party bootstrap gadget (l = 5, b = 6): failure
    below 1e-18 per gate for 5/4 the decomposition rows per step."""
    return _mk_parameters(2, 5, 6)


def mktfhe_parameters_4party() -> SchemeParameters:
    return _mk_parameters(4, 5, 6)


def mktfhe_parameters_8party() -> SchemeParameters:
    return _mk_parameters(8, 8, 4)


def mktfhe_parameters_toy(max_parties: int = 2) -> SchemeParameters:
    """Tiny insecure MK preset for fast tests (the arithmetic is exact at
    any size). The bootstrap noise is the production presets': the
    expansion amplifies the key noise twice, so a loose stddev breaks the
    decryption margin even at toy sizes."""
    return SchemeParameters(
        lwe_size=16, lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=256, tlwe_mask_size=1,
        bs_decomp_length=4, bs_log2_base=7, bs_noise_stddev=3.29e-10,
        ks_decomp_length=8, ks_log2_base=2, ks_noise_stddev=2.0**-15,
        max_parties=max_parties,
    )


@dataclasses.dataclass(frozen=True)
class SharedKey:
    """Server-generated l uniform torus polynomials, common to all
    parties: a int32[l, N]."""

    params: SchemeParameters
    a: torch.Tensor


def make_shared_key(generator: torch.Generator,
                    params: SchemeParameters) -> SharedKey:
    if params.tlwe_mask_size != 1:
        raise ValueError("MK-TFHE requires tlwe_mask_size = 1")
    return SharedKey(params, shared_key_gen(
        generator, params.bs_decomp_length, params.tlwe_polynomial_degree))


@dataclasses.dataclass(frozen=True)
class CloudKeyPart:
    """One party's contribution: public key int32[l, N], uni-encrypted LWE
    key bits [n, 6, l, N], party-local keyswitch key. Travels party ->
    server."""

    params: SchemeParameters
    public_key: torch.Tensor
    key_uni_enc: MKTGswUESample
    keyswitch_key: KeyswitchKey


def make_cloud_key_part(generator: torch.Generator, secret_key: SecretKey,
                        shared: SharedKey) -> CloudKeyPart:
    """Party-side keygen; the fresh TLWE key never leaves this function."""
    params = secret_key.params
    tlwe_key = tlwe_key_gen(generator, params.tlwe_polynomial_degree, 1)
    pk = public_key_gen(generator, tlwe_key, params.bs_noise_stddev, shared.a)
    uni = mk_tgsw_encrypt(
        generator, secret_key.key, params.bs_noise_stddev, tlwe_key, shared.a,
        pk, params.bs_decomp_length, params.bs_log2_base,
        batch_shape=(params.lwe_size,))
    ks = keyswitch_key_gen(
        generator, params.ks_noise_stddev, tlwe_key.reshape(-1),
        secret_key.key, params.ks_decomp_length, params.ks_log2_base)
    return CloudKeyPart(params, pk, uni, ks)


@dataclasses.dataclass(frozen=True)
class MKCloudKey:
    """Assembled server-side evaluation key."""

    params: SchemeParameters
    parties: int
    bootstrap_key: MKBootstrapKey
    keyswitch_keys: tuple  # one KeyswitchKey per party


def make_mk_cloud_key(parts) -> MKCloudKey:
    """Server-side assembly: expand every party's uni-encryptions against
    all public keys."""
    params = parts[0].params
    parties = len(parts)
    if parties > params.max_parties:
        raise ValueError(f"{parties} parties, but the parameters allow "
                         f"{params.max_parties}")
    pk_bs = torch.stack([p.public_key for p in parts])  # [parties, l, N]
    bk = mk_bootstrap_key(
        [p.key_uni_enc for p in parts], pk_bs, params.bs_decomp_length,
        params.bs_log2_base, noise_stddev=params.bs_noise_stddev,
        balanced=params.gadget_balanced)
    return MKCloudKey(params, parties, bk,
                      tuple(p.keyswitch_key for p in parts))


def mk_encrypt(generator: torch.Generator, secret_keys,
               message: torch.Tensor) -> MKLweSample:
    """Joint encryption (needs all parties' secret keys). message:
    bool[...]."""
    params = secret_keys[0].params
    parties = len(secret_keys)
    alpha = params.lwe_noise_stddev
    message = torch.as_tensor(message, device=generator.device).to(torch.bool)
    mu = torch.where(message, encode_message(1, 8),
                     encode_message(-1, 8)).to(torch.int32)
    a = rand_uniform_torus32(generator,
                             tuple(message.shape) + (parties, params.lwe_size))
    keys = torch.stack([sk.key for sk in secret_keys])  # [parties, n]
    b = mu + dtot32(rand_gaussian_float(generator, alpha, message.shape))
    b = b + torch.sum(a * keys, dim=(-1, -2), dtype=torch.int32)
    return MKLweSample(a, b, torch.full(b.shape, alpha**2,
                                        dtype=torch.float32, device=b.device))


def mk_decrypt(secret_keys, sample: MKLweSample) -> torch.Tensor:
    """Joint decryption: the sign of the joined phase."""
    keys = torch.stack([sk.key for sk in secret_keys])
    return mk_lwe_phase(sample, keys) > 0


def mk_partial_decrypt(generator: torch.Generator, secret_key: SecretKey,
                       sample: MKLweSample, party: int,
                       smudging_stddev: float | None = None,
                       statistical_security: float | None = None
                       ) -> torch.Tensor:
    """One party's decryption share: <a_party, s_party> + smudging noise.
    Each party publishes only this share, and `mk_combine_shares` finishes
    the decryption without any secret key.

    The smudging noise must drown the share's key-dependent content, and
    there is no safe universal default, so the caller chooses exactly one
    of:

    * `statistical_security=lam`: sigma_smudge = 2^lam * B_share with
      B_share = 8 * sigma_share, a high-probability magnitude bound on the
      share's key-dependent content (sigma_share from `sample.cv`). A guard
      rejects calibrations whose combined flooding would break decryption:
      all parties' smudges add up in `mk_combine_shares`, and
      16 * (sigma_share^2 + parties * sigma_smudge^2) must stay within
      0.125^2. On a 32-bit torus that caps lam at a few bits.
    * `smudging_stddev`: an explicit stddev, for callers who calibrated
      themselves.
    """
    parties = sample.a.shape[-2]
    if (smudging_stddev is None) == (statistical_security is None):
        raise ValueError(
            "pass exactly one of smudging_stddev / statistical_security "
            "(there is no safe default flooding noise; see docstring)")
    if statistical_security is not None:
        sigma_share = float(sample.cv.max()) ** 0.5
        if sigma_share == 0.0:
            raise ValueError(
                "sample.cv carries no noise estimate; pass an explicit "
                "smudging_stddev")
        b_share = 8.0 * sigma_share
        smudging_stddev = (2.0 ** statistical_security) * b_share
        total = (sigma_share**2 + parties * smudging_stddev**2) ** 0.5
        if 4.0 * total > 0.125:
            headroom = (0.125 / 4.0) ** 2 - sigma_share**2
            max_lam = (math.log2((headroom / parties) ** 0.5 / b_share)
                       if headroom > 0 else float("-inf"))
            raise ValueError(
                f"statistical_security={statistical_security} needs "
                f"sigma_smudge={smudging_stddev:.3g}, but {parties} such "
                f"shares break the 1/8 decision margin "
                f"(4*sigma_total={4 * total:.3g}); max achievable on this "
                f"ciphertext is ~{max_lam:.1f} bits: use lower-noise "
                "parameters or an explicit smudging_stddev")
    dot = torch.sum(sample.a[..., party, :] * secret_key.key, dim=-1,
                    dtype=torch.int32)
    smudge = dtot32(rand_gaussian_float(generator, smudging_stddev,
                                        dot.shape))
    return dot + smudge


def mk_combine_shares(sample: MKLweSample, shares) -> torch.Tensor:
    """Finish a distributed decryption from every party's share (no keys):
    the sign of b - sum_i share_i."""
    total = torch.sum(torch.stack(list(shares)), dim=0, dtype=torch.int32)
    return (sample.b - total) > 0
