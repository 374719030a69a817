"""Analytic noise-variance model for the `cv` field of every sample.

Counterpart of `tfhe_tpu/noise.py`: the same formulas (standard TFHE
external-product and keyswitch variance bounds, and the multi-key chain),
in torus units squared, on the nominal sampling stddev. Python floats in
the reference's order of operations, so a `cv` equals the reference's.
"""

from __future__ import annotations


def decompose_bias_var(mask_size: int, decomp_length: int, log2_base: int,
                       poly_degree: int) -> float:
    """Phase variance of the truncating gadget decomposition's -ulp/2 bias
    convolved with the binary key, per CMUX step (2.5x calibrated)."""
    bias = 2.0 ** -(decomp_length * log2_base + 1)
    d2 = poly_degree / 4.0 + poly_degree**2 / 12.0
    return 2.5 * mask_size * d2 * bias * bias


def extern_product_var(mask_size: int, decomp_length: int, log2_base: int,
                       poly_degree: int, sigma_bk: float,
                       balanced: bool = False) -> float:
    """Phase variance added by one TGSW external product (one CMUX step):
    digit-times-key-noise, zero-mean gadget rounding, and the rounding bias
    (zero for the balanced gadget)."""
    k1 = mask_size + 1
    e_dig2 = (1 << (2 * log2_base)) / 12.0
    eps = 2.0 ** -(decomp_length * log2_base + 1)
    bias = 0.0 if balanced else decompose_bias_var(
        mask_size, decomp_length, log2_base, poly_degree)
    return (k1 * decomp_length * poly_degree * e_dig2 * sigma_bk**2
            + (1 + mask_size * poly_degree / 2.0) * eps * eps
            + bias)


def blind_rotate_var(n_steps: int, mask_size: int, decomp_length: int,
                     log2_base: int, poly_degree: int,
                     sigma_bk: float, balanced: bool = False) -> float:
    """n accumulated CMUX steps."""
    return n_steps * extern_product_var(
        mask_size, decomp_length, log2_base, poly_degree, sigma_bk, balanced)


def keyswitch_var(n_in: int, decomp_length: int, log2_base: int,
                  sigma_ks: float) -> float:
    """Keyswitch-added variance: one table sample per nonzero digit plus
    the round-to-l*b-bits error carried through the binary in-key."""
    base = 1 << log2_base
    nonzero = (base - 1) / base
    round_err = 2.0 ** -(decomp_length * log2_base + 1)
    return (n_in * decomp_length * nonzero * sigma_ks**2
            + n_in * 0.5 * round_err * round_err / 3.0)


def mk_expand_var(parties: int, decomp_length: int, log2_base: int,
                  poly_degree: int, sigma: float) -> float:
    """Noise variance of an expanded MK-TGSW column (x_ij, i != party):
    d0's fresh noise + <g^-1(pk diff), f0-noise>."""
    e_dig2 = (1 << (2 * log2_base)) / 12.0
    return sigma**2 * (1 + decomp_length * poly_degree * e_dig2)


def mk_extern_product_var(parties: int, decomp_length: int, log2_base: int,
                          poly_degree: int, sigma: float,
                          balanced: bool = False) -> float:
    """One multi-key CMUX step: (parties-1) mask columns carry expanded
    noise, the party's own column and the body fresh noise; plus the gadget
    rounding terms, the expansion's rounding re-amplified by the extern
    digits, and (truncating gadget only) the -ulp/2 bias through the
    `parties` ring keys."""
    e_dig2 = (1 << (2 * log2_base)) / 12.0
    v_exp = mk_expand_var(parties, decomp_length, log2_base, poly_degree,
                          sigma)
    eps = 2.0 ** -(decomp_length * log2_base + 1)
    bias = 0.0 if balanced else parties * decompose_bias_var(
        1, decomp_length, log2_base, poly_degree)
    exp_round = (decomp_length * poly_degree * e_dig2
                 * (parties - 1) * (poly_degree / 2.0) * eps * eps)
    return (decomp_length * poly_degree * e_dig2
            * ((parties - 1) * v_exp + 2 * sigma**2)
            + (1 + parties * poly_degree / 2.0) * eps * eps
            + exp_round + bias)


def mk_blind_rotate_var(parties: int, lwe_size: int, decomp_length: int,
                        log2_base: int, poly_degree: int,
                        sigma: float, balanced: bool = False) -> float:
    """parties * n accumulated multi-key CMUX steps."""
    return parties * lwe_size * mk_extern_product_var(
        parties, decomp_length, log2_base, poly_degree, sigma, balanced)
