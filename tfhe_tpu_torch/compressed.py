"""Seeded (compressed) ciphertexts and keys, and modulus-switched results.

Counterpart of `tfhe_tpu/compressed.py`. Every uniform mask is the output
of a PRNG, so a fresh ciphertext or a key can travel as (seed, bodies) and
the receiver regenerates the masks:

* `SeededLweSample`: (seed, b), one word per ciphertext instead of n+1;
* `SeededKeyswitchKey`: (seed, bodies [base-1, l, n_in]);
* `SeededBootstrapKey`: (seed, bodies [n, l, k+1, N]); the gadget message
  of TGSW row (i, j < k) is carried on its body as -m*g_i*s_j (the same
  phase, so the same external products and noise), so that every mask is
  pure PRNG output. Its expansion bakes the key through
  `bootstrap.bootstrap_key_from_raw`, so a key expanded on a CUDA card
  comes out K-major;
* `SeededCloudKey`: the parameters and the two seeded keys;
* the multi-key ceremony's `SeededSharedKey` (one seed) and
  `SeededCloudKeyPart` (the public key, the bodies of each
  uni-encryption's (c0, d0, d1, f0) rows, the seeds of its uniform c1 and
  f1 rows, and a seeded keyswitch key).

Seeds are threefry keys, uint32[2], and the masks expand through
`threefry.py`, the twin of the reference's `jax.random` layout: the same
stored seed gives the same masks in both packages, so a seeded artifact
made by either loads and expands in the other (`utils/serialization.py`).
A seeded keygen here draws its mask seeds from its `torch.Generator` and
its noise and secrets from that generator as every keygen of the port
does, so its words differ from the reference's for the same seed number;
what the artifacts share is their format and their expansion.

Results computed by the server have no seed; `compress_lwe` rounds every
word to its top `bits` bits (modulus switching) and stores them in the
narrowest integer type, `decompress_lwe` puts them back.
"""

from __future__ import annotations

import dataclasses

import torch

from .api import CloudKey, SecretKey
from .bootstrap import BootstrapKey, bootstrap_key_from_raw
from .keyswitch import KeyswitchKey, keyswitch_bodies, prepare_keyswitch_table
from .lwe import LweSample, lwe_encrypt_core
from .numeric import (decode_message, dtot32, encode_message,
                      rand_gaussian_float, rand_uniform_bool)
from .params import SchemeParameters
from .tgsw import gadget_values
from .threefry import key_from_generator, uniform_torus32
from .tlwe import extract_lwe_key, tlwe_encrypt_zero_core, tlwe_key_gen

# ---------------------------------------------------------------------------
# Seeded LWE ciphertexts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeededLweSample:
    """A batch of fresh LWE ciphertexts as (mask seed, bodies).

    seed: uint32[2] threefry key; b: int32[...]; n: the LWE dimension the
    masks expand to (one draw of shape b.shape + (n,) for the batch).
    """

    seed: torch.Tensor
    b: torch.Tensor
    cv: torch.Tensor
    n: int

    @property
    def batch_shape(self):
        return tuple(self.b.shape)


def _seeded_lwe(generator: torch.Generator, mu: torch.Tensor, alpha: float,
                key: torch.Tensor) -> SeededLweSample:
    """Encrypt the phases mu under `key` with masks from a fresh seed."""
    seed = key_from_generator(generator)
    n = key.shape[-1]
    a = uniform_torus32(seed, tuple(mu.shape) + (n,), generator.device)
    noise = dtot32(rand_gaussian_float(generator, alpha, mu.shape))
    sample = lwe_encrypt_core(mu, a, noise, key)
    return SeededLweSample(seed, sample.b,
                           torch.full(sample.b.shape, alpha**2,
                                      dtype=torch.float32,
                                      device=sample.b.device), n)


def encrypt_seeded(generator: torch.Generator, key: SecretKey,
                   message) -> SeededLweSample:
    """Seeded twin of `api.encrypt`: one word per ciphertext on the wire."""
    message = torch.as_tensor(message, dtype=torch.bool,
                              device=generator.device)
    mu = torch.where(message, encode_message(1, 8), encode_message(-1, 8))
    return _seeded_lwe(generator, mu.to(torch.int32),
                       key.params.lwe_noise_stddev, key.key)


def expand_lwe(sample: SeededLweSample) -> LweSample:
    """Regenerate the masks from the seed: the full LweSample."""
    a = uniform_torus32(sample.seed, sample.batch_shape + (sample.n,),
                        sample.b.device)
    return LweSample(a, sample.b, sample.cv)


# ---------------------------------------------------------------------------
# Seeded keyswitch key
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeededKeyswitchKey:
    """Keyswitch key as (mask seed, bodies b[base-1, l, n_in]); expansion
    rebuilds the prepared table of `keyswitch.KeyswitchKey`."""

    seed: torch.Tensor
    b: torch.Tensor
    n_in: int
    n_out: int
    decomp_length: int
    log2_base: int
    noise_stddev: float = 0.0


def keyswitch_key_gen_seeded(generator: torch.Generator, alpha: float,
                             in_key: torch.Tensor, out_key: torch.Tensor,
                             decomp_length: int,
                             log2_base: int) -> SeededKeyswitchKey:
    """Seeded twin of `keyswitch_key_gen` (the same recentred noise)."""
    base = 1 << log2_base
    n_in, n_out = in_key.shape[0], out_key.shape[0]
    noise = rand_gaussian_float(generator, alpha,
                                (n_in, decomp_length, base - 1))
    noise = noise - noise.mean()
    seed = key_from_generator(generator)
    a = uniform_torus32(seed, (base - 1, decomp_length, n_in, n_out),
                        generator.device)
    b = keyswitch_bodies(in_key, out_key, a, dtot32(noise.permute(2, 1, 0)),
                         decomp_length, log2_base)
    return SeededKeyswitchKey(seed, b, n_in, n_out, decomp_length, log2_base,
                              noise_stddev=alpha)


def expand_keyswitch_key(ks: SeededKeyswitchKey) -> KeyswitchKey:
    """Regenerate the masks and rebuild the prepared limb table."""
    base = 1 << ks.log2_base
    a = uniform_torus32(ks.seed,
                        (base - 1, ks.decomp_length, ks.n_in, ks.n_out),
                        ks.b.device)
    return KeyswitchKey(prepare_keyswitch_table(a, ks.b, ks.n_out), ks.n_in,
                        ks.n_out, ks.decomp_length, ks.log2_base,
                        ks.noise_stddev)


# ---------------------------------------------------------------------------
# Seeded bootstrap key
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeededBootstrapKey:
    """Bootstrap key as (mask seed, row bodies int32[n, l, k+1, N]), with
    the body-side message placement of the module docstring."""

    seed: torch.Tensor
    body: torch.Tensor
    decomp_length: int
    log2_base: int
    polynomial_degree: int
    mask_size: int
    noise_stddev: float = 0.0
    balanced: bool = False  # the gate-time gadget rounding

    @property
    def n(self) -> int:
        return self.body.shape[0]


def _mask_shape(n: int, l: int, k: int, poly_n: int) -> tuple:
    return (n, l, k + 1, k, poly_n)


def bootstrap_key_gen_seeded(generator: torch.Generator, alpha: float,
                             lwe_key: torch.Tensor, tlwe_key: torch.Tensor,
                             decomp_length: int, log2_base: int,
                             balanced: bool = False) -> SeededBootstrapKey:
    """TGSW-encrypt each LWE key bit with the message on the bodies: row
    (i, j < k) gets -m*g_i*s_j, row (i, k) +m*g_i on its constant term."""
    n = lwe_key.shape[0]
    k, poly_n = tlwe_key.shape
    l = decomp_length
    dev = generator.device
    seed = key_from_generator(generator)
    a_part = uniform_torus32(seed, _mask_shape(n, l, k, poly_n), dev)
    noise = dtot32(rand_gaussian_float(generator, alpha,
                                       (n, l, k + 1, poly_n)))
    body = tlwe_encrypt_zero_core(a_part, noise, tlwe_key).a[..., -1, :]
    g = torch.tensor(gadget_values(l, log2_base), dtype=torch.int32,
                     device=dev)
    mg = lwe_key.to(torch.int32)[:, None] * g[None, :]  # [n, l]
    mask_row_bump = -(mg[:, :, None, None] * tlwe_key[None, None])
    body_row_bump = torch.zeros((n, l, 1, poly_n), dtype=torch.int32,
                                device=dev)
    body_row_bump[:, :, 0, 0] = mg
    bump = torch.cat([mask_row_bump, body_row_bump], dim=2)  # [n, l, k+1, N]
    return SeededBootstrapKey(seed, body + bump, l, log2_base, poly_n, k,
                              noise_stddev=alpha, balanced=balanced)


def expand_bootstrap_key(bk: SeededBootstrapKey, block: int | None = None,
                         depth: int | None = None) -> BootstrapKey:
    """Regenerate the masks, reassemble the raw TGSW rows and build the key
    in the form `tuning` chooses (K-major on a CUDA card when baked)."""
    a_part = uniform_torus32(
        bk.seed, _mask_shape(bk.n, bk.decomp_length, bk.mask_size,
                             bk.polynomial_degree), bk.body.device)
    gsw = torch.cat([a_part, bk.body.unsqueeze(-2)], dim=-2)
    del a_part
    return bootstrap_key_from_raw(gsw, bk.decomp_length, bk.log2_base, block,
                                  depth, noise_stddev=bk.noise_stddev,
                                  balanced=bk.balanced)


# ---------------------------------------------------------------------------
# Seeded cloud key
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeededCloudKey:
    """The whole evaluation key as one small wire artifact."""

    params: SchemeParameters
    bootstrap_key: SeededBootstrapKey
    keyswitch_key: SeededKeyswitchKey


def make_seeded_cloud_key(generator: torch.Generator,
                          secret_key: SecretKey) -> SeededCloudKey:
    """Seeded twin of `api.make_cloud_key`: the fresh TLWE key never
    leaves this function."""
    params = secret_key.params
    tlwe_key = tlwe_key_gen(generator, params.tlwe_polynomial_degree,
                            params.tlwe_mask_size)
    bs_key = bootstrap_key_gen_seeded(
        generator, params.bs_noise_stddev, secret_key.key, tlwe_key,
        params.bs_decomp_length, params.bs_log2_base,
        balanced=params.gadget_balanced)
    ks_key = keyswitch_key_gen_seeded(
        generator, params.ks_noise_stddev, extract_lwe_key(tlwe_key),
        secret_key.key, params.ks_decomp_length, params.ks_log2_base)
    return SeededCloudKey(params, bs_key, ks_key)


def expand_cloud_key(ck: SeededCloudKey, block: int | None = None,
                     depth: int | None = None) -> CloudKey:
    """Server-side expansion into the CloudKey the gates take, on the
    device of the seeded key's tensors."""
    return CloudKey(ck.params,
                    expand_bootstrap_key(ck.bootstrap_key, block, depth),
                    expand_keyswitch_key(ck.keyswitch_key))


# ---------------------------------------------------------------------------
# Seeded multi-key ceremony artifacts
# ---------------------------------------------------------------------------
#
# The shared key is public randomness and ships as one seed. Inside each
# uni-encryption c1 and f1 are uniform (2 of its 6 polynomial vectors) and
# ship as seeds; its randomness r and its noise come from the party's
# generator and never leave, so publishing the c1/f1 seeds reveals exactly
# the public values they expand to.


@dataclasses.dataclass(frozen=True)
class SeededSharedKey:
    """The common reference string as one threefry seed."""

    params: SchemeParameters
    seed: torch.Tensor


def make_shared_key_seeded(generator: torch.Generator,
                           params: SchemeParameters) -> SeededSharedKey:
    """Seeded twin of `mk.make_shared_key`."""
    if params.tlwe_mask_size != 1:
        raise ValueError("MK-TFHE requires tlwe_mask_size = 1")
    return SeededSharedKey(params, key_from_generator(generator))


def expand_shared_key(sk: SeededSharedKey):
    """The SharedKey, on the seed's device."""
    from .mk.api import SharedKey

    p = sk.params
    return SharedKey(p, uniform_torus32(
        sk.seed, (p.bs_decomp_length, p.tlwe_polynomial_degree),
        sk.seed.device))


@dataclasses.dataclass(frozen=True)
class SeededCloudKeyPart:
    """One party's ceremony contribution in seeded wire form.

    public_key: int32[l, N] bodies (its masks are the shared key);
    ue_seeds: uint32[2, 2], the seeds of the c1 and f1 rows;
    ue_bodies: int32[n, 4, l, N], the (c0, d0, d1, f0) rows of each
    uni-encryption; keyswitch_key: the party's seeded keyswitch key.
    """

    params: SchemeParameters
    public_key: torch.Tensor
    ue_seeds: torch.Tensor
    ue_bodies: torch.Tensor
    keyswitch_key: SeededKeyswitchKey


def make_seeded_cloud_key_part(generator: torch.Generator,
                               secret_key: SecretKey,
                               shared) -> SeededCloudKeyPart:
    """Party-side seeded keygen (the seeded twin of
    `mk.make_cloud_key_part`); `shared` is the expanded SharedKey."""
    from .mk.internals import mk_tgsw_encrypt_core, public_key_gen

    params = secret_key.params
    n, l = params.lwe_size, params.bs_decomp_length
    poly_n = params.tlwe_polynomial_degree
    alpha = params.bs_noise_stddev
    dev = generator.device
    tlwe_key = tlwe_key_gen(generator, poly_n, 1)
    pk = public_key_gen(generator, tlwe_key, alpha, shared.a)
    ue_seeds = torch.stack([key_from_generator(generator),
                            key_from_generator(generator)])
    c1 = uniform_torus32(ue_seeds[0], (n, l, poly_n), dev)
    f1 = uniform_torus32(ue_seeds[1], (n, l, poly_n), dev)
    r = rand_uniform_bool(generator, (n, poly_n))
    noises = [dtot32(rand_gaussian_float(generator, alpha, (n, l, poly_n)))
              for _ in range(4)]
    uni = mk_tgsw_encrypt_core(
        secret_key.key, r, c1, f1, *noises, tlwe_key, shared.a, pk, l,
        params.bs_log2_base)
    del c1, f1, noises
    ue_bodies = uni.cd[:, [0, 2, 3, 4]].contiguous()
    ks = keyswitch_key_gen_seeded(
        generator, params.ks_noise_stddev, tlwe_key.reshape(-1),
        secret_key.key, params.ks_decomp_length, params.ks_log2_base)
    return SeededCloudKeyPart(params, pk, ue_seeds, ue_bodies, ks)


def expand_cloud_key_part(part: SeededCloudKeyPart):
    """Server-side expansion into the full CloudKeyPart, on the device of
    the part's tensors."""
    from .mk.api import CloudKeyPart
    from .mk.internals import MKTGswUESample

    params = part.params
    n = part.ue_bodies.shape[0]
    shape = (n, params.bs_decomp_length, params.tlwe_polynomial_degree)
    dev = part.ue_bodies.device
    c1 = uniform_torus32(part.ue_seeds[0], shape, dev)
    f1 = uniform_torus32(part.ue_seeds[1], shape, dev)
    c0, d0, d1, f0 = part.ue_bodies.unbind(1)
    cd = torch.stack([c0, c1, d0, d1, f0, f1], dim=1)
    return CloudKeyPart(params, part.public_key, MKTGswUESample(cd),
                        expand_keyswitch_key(part.keyswitch_key))


# ---------------------------------------------------------------------------
# Post-compute ciphertext compression (modulus switching)
# ---------------------------------------------------------------------------
#
# Results have computed masks and cannot be seeded. They compress by
# rounding every torus word to its top `bits` bits (the round-to-nearest of
# `numeric.decode_message`, as the bootstrap's switch to 2N), which adds
# uniform noise of width 2^-bits per word: across the phase about
# (1 + n/4) * 2^(-2*bits) / 12, folded into cv. 16 bits halve the result
# wire at about 7e-5 sigma, far inside the 1/16 gate margin.


@dataclasses.dataclass(frozen=True)
class CompressedLweSample:
    """Modulus-switched LWE batch: a [..., n] and b [...] hold the top
    `bits` bits, values in [-2^(bits-1), 2^(bits-1)), in the narrowest
    integer type that fits (int8, int16 or int32)."""

    a: torch.Tensor
    b: torch.Tensor
    cv: torch.Tensor
    bits: int


def _narrow_dtype(bits: int):
    return torch.int8 if bits <= 8 else torch.int16 if bits <= 16 \
        else torch.int32


def compress_lwe(sample: LweSample, bits: int = 16) -> CompressedLweSample:
    """Round a ciphertext batch to `bits`-bit torus words."""
    if not 1 < bits <= 32:
        raise ValueError(f"bits must be in (1, 32], got {bits}")
    if bits == 32:
        return CompressedLweSample(sample.a, sample.b, sample.cv, bits)
    space = 1 << bits  # decode_message keeps log2(space) = bits top bits
    dt = _narrow_dtype(bits)
    a = decode_message(sample.a, space).to(dt)
    b = decode_message(sample.b, space).to(dt)
    n = sample.a.shape[-1]
    round_var = (1.0 + n / 4.0) * float(2.0 ** (-2 * bits)) / 12.0
    return CompressedLweSample(a, b, sample.cv + round_var, bits)


def decompress_lwe(c: CompressedLweSample) -> LweSample:
    """Back to full torus words (the top bits, zeros below)."""
    if c.bits == 32:
        return LweSample(c.a, c.b, c.cv)
    shift = 32 - c.bits
    return LweSample(c.a.to(torch.int32) << shift,
                     c.b.to(torch.int32) << shift, c.cv)
