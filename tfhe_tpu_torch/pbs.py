"""Programmable bootstrapping: arbitrary lookup tables in one bootstrap.

Counterpart of `tfhe_tpu/pbs.py`. The blind rotation already evaluates
`testvector[phase_index]`; encoding a lookup table into the test polynomial
turns each bootstrap into an exact S-entry table evaluation. It runs on the
same keys and the same rotation kernels as the gates.

Encoding (one padding bit): message m in [0, S) has phase m/(2S), so the
mod-switched rotation index is m*(N/S) +- noise, always in the first half of
the 2N ring. A half-window pre-rotation (barb + w/2) recenters each
message's noise window to [m*w, (m+1)*w), so the negacyclic wrap never flips
the sign of the extracted coefficient, and the test polynomial repeats each
table entry w = N/S times. Correct while |phase noise| < 1/(4S).

Tables and constants are created on the device of the ciphertext (or, for
encryption, of the generator).
"""

from __future__ import annotations

import torch

from . import polynomial
from .api import SecretKey
from .bootstrap import BootstrapKey, blind_rotate, blind_rotate_and_extract
from .keyswitch import KeyswitchKey, keyswitch
from .lwe import LweSample, lwe_encrypt, lwe_phase
from .numeric import (decode_message, dtot32, input_device,
                      rand_gaussian_float, rand_uniform_torus32)
from .tlwe import (TLweSample, tlwe_extract_sample, tlwe_mul_by_monomial,
                   tlwe_noiseless_trivial)


def _log2(space: int) -> int:
    log2_s = space.bit_length() - 1
    assert 1 << log2_s == space, "message space must be a power of 2"
    return log2_s


def encode_pbs(message, space: int, device=None) -> torch.Tensor:
    """m in [0, S) -> torus phase m/(2S) (one padding bit), int32, on
    `device`, or else on the device of a tensor `message`, or else the
    card."""
    shift = 32 - (_log2(space) + 1)
    return torch.as_tensor(message, device=input_device(message, device)) \
        .to(torch.int32) << shift


def decode_pbs(phase: torch.Tensor, space: int) -> torch.Tensor:
    """Torus phase -> nearest message in [0, 2S) (mod 2S on the ring)."""
    return torch.remainder(decode_message(phase, 2 * space), 2 * space)


def encrypt_pbs(generator: torch.Generator, key: SecretKey, message,
                space: int) -> LweSample:
    """Encrypt integer message(s) in [0, S) under the PBS encoding."""
    mu = encode_pbs(message, space, generator.device)
    return lwe_encrypt(generator, mu, key.params.lwe_noise_stddev, key.key)


def decrypt_pbs(key: SecretKey, sample: LweSample, space: int) -> torch.Tensor:
    """Decrypt to integer message(s) in [0, 2S) (values >= S mean failure)."""
    return decode_pbs(lwe_phase(sample, key.key), space)


def lut_test_polynomial(table, space: int, polynomial_degree: int,
                        device=None) -> torch.Tensor:
    """LUT (plaintext ints in [0, S), shape [..., S]) -> test polynomial
    int32[..., N]: each entry repeated across its w = N/S index window.
    Outputs carry the same PBS encoding, so bootstraps compose. Placed as
    `encode_pbs` places it."""
    enc = encode_pbs(table, space, device)
    assert enc.shape[-1] == space
    w = polynomial_degree // space
    assert w * space == polynomial_degree
    return torch.repeat_interleave(enc, w, dim=-1)


def _flatten(x):
    """A sample with any batch shape as one flat batch."""
    return (x.a.reshape((-1,) + tuple(x.a.shape[x.b.dim():])),
            x.b.reshape(-1))


def _per_sample(testvect: torch.Tensor, batch_shape, p_degree: int):
    """Broadcast a test polynomial's leading dims against the batch and
    flatten to a contiguous [B, N]."""
    return testvect.expand(tuple(batch_shape) + (p_degree,)) \
        .reshape(-1, p_degree).contiguous()


def programmable_bootstrap_wo_keyswitch(bk: BootstrapKey, table,
                                        x: LweSample,
                                        space: int) -> LweSample:
    """The LUT blind rotation, in the extracted (N*k)-dim LWE space.

    table: int[..., S] plaintext LUT; its leading dims broadcast against
    x's batch shape, so per-sample tables are allowed. Only the test vector
    and the half-window pre-rotation differ from the gate bootstrap.
    """
    p_degree = bk.polynomial_degree
    w = p_degree // space
    batch_shape = tuple(x.b.shape)
    flat_a, flat_b = _flatten(x)
    bara = decode_message(flat_a, p_degree * 2)
    barb = decode_message(flat_b, p_degree * 2) + (w // 2)
    testvect = _per_sample(
        lut_test_polynomial(table, space, p_degree, x.a.device),
        batch_shape, p_degree)
    out = blind_rotate_and_extract(testvect, bk, barb, bara)
    return LweSample(out.a.reshape(batch_shape + (out.a.shape[-1],)),
                     out.b.reshape(batch_shape), out.cv.reshape(batch_shape))


def programmable_bootstrap(bk: BootstrapKey, ks: KeyswitchKey, table,
                           x: LweSample, space: int) -> LweSample:
    """LWE(table[m]/(2S)) from LWE(m/(2S)): one LUT evaluation per sample."""
    return keyswitch(ks, programmable_bootstrap_wo_keyswitch(
        bk, table, x, space))


# --- Many-LUT: q tables per blind rotation ---
#
# The blind rotation lands the accumulator at v * X^(-p) with
# p = m*w + w/2 + e; the single-LUT path reads only coefficient 0. Rounding
# the modulus switch to multiples of q (the 2N/q grid) pins p = w/2 (mod q),
# so coefficients 0..q-1 of the same rotated polynomial address q
# interleaved tables: v[m*w + r] = T_{r mod q}[m]. One rotation then yields
# q LUT outputs; extraction at coefficient r is an exact monomial shift. The
# price is a mod-switch rounding error q times larger.


def lut_many_test_polynomial(tables, space: int, q: int,
                             polynomial_degree: int,
                             device=None) -> torch.Tensor:
    """tables int[..., q, S] -> v[..., N] with v[m*w + r] = enc(T_{r%q}[m]),
    placed as `encode_pbs` places it."""
    enc = encode_pbs(tables, space, device)  # [..., q, S]
    assert enc.shape[-2] == q and enc.shape[-1] == space
    w = polynomial_degree // space
    assert w * space == polynomial_degree and w % q == 0
    which = torch.arange(w, device=enc.device) % q
    cols = torch.index_select(enc, -2, which)  # [..., w, S]
    v = torch.movedim(cols, -2, -1)  # [..., S, w]
    return v.reshape(tuple(v.shape[:-2]) + (space * w,))


def _many_lut_switch(a: torch.Tensor, b: torch.Tensor, p_degree: int,
                     space: int, q: int):
    """The many-LUT modulus switch: (bara, barb) on the 2N/q grid, barb with
    the half-window pre-rotation."""
    w = p_degree // space
    assert q >= 1 and (q & (q - 1)) == 0 and (w // 2) % q == 0, (q, w)
    grid = (p_degree * 2) // q
    return (decode_message(a, grid) * q,
            decode_message(b, grid) * q + (w // 2))


def programmable_bootstrap_many_wo_keyswitch(bk: BootstrapKey, tables,
                                             x: LweSample, space: int,
                                             q: int) -> LweSample:
    """q LUT evaluations per sample from one blind rotation.

    tables: int[..., q, S] (leading dims broadcast against x's batch);
    returns samples with batch shape x.batch + (q,) in the extracted
    (N*k)-dim space, entry r holding tables[r][m].
    """
    p_degree = bk.polynomial_degree
    batch_shape = tuple(x.b.shape)
    flat_a, flat_b = _flatten(x)
    bara, barb = _many_lut_switch(flat_a, flat_b, p_degree, space, q)
    testvect = _per_sample(
        lut_many_test_polynomial(tables, space, q, p_degree, x.a.device),
        batch_shape, p_degree)
    accum = tlwe_noiseless_trivial(
        polynomial.mul_by_monomial(testvect, -barb), bk.mask_size)
    accum = blind_rotate(accum, bk, bara)
    outs = [tlwe_extract_sample(tlwe_mul_by_monomial(accum, -r) if r
                                else accum) for r in range(q)]
    a = torch.stack([o.a for o in outs], dim=-2)
    b = torch.stack([o.b for o in outs], dim=-1)
    cv = torch.stack([o.cv for o in outs], dim=-1)
    return LweSample(a.reshape(batch_shape + (q, a.shape[-1])),
                     b.reshape(batch_shape + (q,)),
                     cv.reshape(batch_shape + (q,)))


def programmable_bootstrap_many(bk: BootstrapKey, ks: KeyswitchKey, tables,
                                x: LweSample, space: int,
                                q: int) -> LweSample:
    """q LUT outputs per input sample: one blind rotation, then one
    keyswitch over all of them; result batch shape x.batch + (q,)."""
    return keyswitch(ks, programmable_bootstrap_many_wo_keyswitch(
        bk, tables, x, space, q))


# --- Multi-key PBS: the same constructions on the MK blind rotation ---


def mk_encrypt_pbs(generator: torch.Generator, secret_keys, message,
                   space: int):
    """Joint MK encryption of integer message(s) in [0, S) (PBS encoding)."""
    from .mk.internals import MKLweSample

    params = secret_keys[0].params
    parties, n = len(secret_keys), params.lwe_size
    alpha = params.lwe_noise_stddev
    mu = encode_pbs(message, space, generator.device)
    a = rand_uniform_torus32(generator, tuple(mu.shape) + (parties, n))
    keys = torch.stack([sk.key for sk in secret_keys])
    b = mu + dtot32(rand_gaussian_float(generator, alpha, mu.shape))
    b = b + torch.sum(a * keys, dim=(-1, -2), dtype=torch.int32)
    return MKLweSample(a, b, torch.full(b.shape, alpha**2,
                                        dtype=torch.float32, device=b.device))


def mk_decrypt_pbs(secret_keys, sample, space: int) -> torch.Tensor:
    """Joint MK decryption to integer message(s) in [0, 2S)."""
    from .mk.internals import mk_lwe_phase

    keys = torch.stack([sk.key for sk in secret_keys])
    return decode_pbs(mk_lwe_phase(sample, keys), space)


def _mk_flatten(x):
    return x.a.reshape((-1,) + tuple(x.a.shape[-2:])), x.b.reshape(-1)


def _mk_unflatten(out, batch_shape):
    return type(out)(out.a.reshape(batch_shape + tuple(out.a.shape[-2:])),
                     out.b.reshape(batch_shape), out.cv.reshape(batch_shape))


def mk_programmable_bootstrap(bk, ks_keys, table, x, space: int,
                              segments: int = 1):
    """Multi-key LUT evaluation: one MK bootstrap per sample, the
    construction of `programmable_bootstrap` on the MK blind rotation.
    x: any batch shape [..., parties, n]."""
    from .mk.internals import mk_blind_rotate_and_extract, mk_keyswitch

    p_degree = bk.polynomial_degree
    w = p_degree // space
    batch_shape = tuple(x.b.shape)
    flat_a, flat_b = _mk_flatten(x)
    bara = decode_message(flat_a, p_degree * 2)
    barb = decode_message(flat_b, p_degree * 2) + (w // 2)
    testvect = _per_sample(
        lut_test_polynomial(table, space, p_degree, x.a.device),
        batch_shape, p_degree)
    u = mk_blind_rotate_and_extract(testvect, bk, barb, bara, segments)
    return _mk_unflatten(mk_keyswitch(ks_keys, u), batch_shape)


def mk_programmable_bootstrap_many(bk, ks_keys, tables, x, space: int,
                                   q: int, segments: int = 1):
    """Multi-key many-LUT: q LUT outputs per MK blind rotation, the
    construction of `programmable_bootstrap_many` on the MK rotation.
    Result batch shape x.batch + (q,)."""
    from .mk.internals import (MKLweSample, mk_blind_rotate, mk_keyswitch,
                               mk_tlwe_extract_sample,
                               mk_tlwe_noiseless_trivial)

    p_degree = bk.polynomial_degree
    batch_shape = tuple(x.b.shape)
    flat_a, flat_b = _mk_flatten(x)
    bara, barb = _many_lut_switch(flat_a, flat_b, p_degree, space, q)
    testvect = _per_sample(
        lut_many_test_polynomial(tables, space, q, p_degree, x.a.device),
        batch_shape, p_degree)
    accum = mk_tlwe_noiseless_trivial(
        polynomial.mul_by_monomial(testvect, -barb), bk.parties)
    accum = mk_blind_rotate(accum, bk, bara, segments)
    outs = []
    for r in range(q):
        rot = (TLweSample(polynomial.mul_by_monomial(accum.a, -r), accum.cv)
               if r else accum)
        outs.append(_mk_unflatten(
            mk_keyswitch(ks_keys, mk_tlwe_extract_sample(rot)), batch_shape))
    return MKLweSample(torch.stack([o.a for o in outs], dim=-3),
                       torch.stack([o.b for o in outs], dim=-1),
                       torch.stack([o.cv for o in outs], dim=-1))
