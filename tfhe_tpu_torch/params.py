"""Scheme parameters: one frozen config per preset.

Counterpart of `tfhe_tpu/params.py`. The presets are plain data and are
re-stated here so that the port never imports the JAX package; a test pins
every field of every preset equal to the reference. The reasoning behind
each preset (security, noise margins) lives in the reference's docstrings.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SchemeParameters:
    """All scheme parameters (the same 12 fields as the reference)."""

    lwe_size: int
    lwe_noise_stddev: float

    tlwe_polynomial_degree: int
    tlwe_mask_size: int

    bs_decomp_length: int
    bs_log2_base: int
    bs_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int = 1

    # Nearest-rounding ("balanced") gadget decomposition in the bootstrap's
    # external products (tgsw.decomp_offset).
    gadget_balanced: bool = False

    @property
    def n(self) -> int:
        return self.lwe_size

    @property
    def N(self) -> int:
        return self.tlwe_polynomial_degree

    @property
    def k(self) -> int:
        return self.tlwe_mask_size

    @property
    def extracted_size(self) -> int:
        """LWE dimension after sample extraction."""
        return self.tlwe_polynomial_degree * self.tlwe_mask_size

    @property
    def bs_base(self) -> int:
        return 1 << self.bs_log2_base

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_log2_base


def tfhe_parameters_80(tlwe_mask_size: int = 1) -> SchemeParameters:
    """~80-bit security preset (CGGI parameters)."""
    return SchemeParameters(
        lwe_size=500,
        lwe_noise_stddev=2.0**-15 * math.sqrt(2.0 / math.pi),
        tlwe_polynomial_degree=1024,
        tlwe_mask_size=tlwe_mask_size,
        bs_decomp_length=2,
        bs_log2_base=10,
        bs_noise_stddev=9e-9 * math.sqrt(2.0 / math.pi),
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15 * math.sqrt(2.0 / math.pi),
        max_parties=1,
    )


def tfhe_parameters_128(tlwe_mask_size: int = 1) -> SchemeParameters:
    """~128-bit security preset (CGGI2019)."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=1024,
        tlwe_mask_size=tlwe_mask_size,
        bs_decomp_length=3,
        bs_log2_base=7,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
    )


def tfhe_parameters_128_fast() -> SchemeParameters:
    """~128-bit preset re-split as k=4, N=256 with a balanced l=2, b=8
    gadget: the same dimension-1024 lattice instance as
    `tfhe_parameters_128` at fewer byte-MACs per gate."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=256,
        tlwe_mask_size=4,
        bs_decomp_length=2,
        bs_log2_base=8,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
        gadget_balanced=True,
    )


def tfhe_parameters_128_fast8() -> SchemeParameters:
    """The k=8, N=128 re-split of the 128-bit instance (M=1; compact key
    only in the reference)."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=128,
        tlwe_mask_size=8,
        bs_decomp_length=2,
        bs_log2_base=8,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
        gadget_balanced=True,
    )


def tfhe_parameters_128_pbs() -> SchemeParameters:
    """~128-bit preset for programmable bootstrapping (k=2, N=512)."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=512,
        tlwe_mask_size=2,
        bs_decomp_length=3,
        bs_log2_base=7,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
    )


def tfhe_parameters_128_radix() -> SchemeParameters:
    """~128-bit preset for radix integer arithmetic."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=1024,
        tlwe_mask_size=1,
        bs_decomp_length=3,
        bs_log2_base=7,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=4,
        ks_log2_base=4,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
        gadget_balanced=True,
    )


def tfhe_parameters_128_radix_reliable() -> SchemeParameters:
    """~128-bit radix preset for hard reliability targets (l=4, b=6)."""
    return SchemeParameters(
        lwe_size=630,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=1024,
        tlwe_mask_size=1,
        bs_decomp_length=4,
        bs_log2_base=6,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=4,
        ks_log2_base=4,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
        gadget_balanced=True,
    )


def tfhe_parameters_toy() -> SchemeParameters:
    """Tiny insecure parameters for equality tests only."""
    return SchemeParameters(
        lwe_size=16,
        lwe_noise_stddev=2.0**-15,
        tlwe_polynomial_degree=256,
        tlwe_mask_size=1,
        bs_decomp_length=3,
        bs_log2_base=7,
        bs_noise_stddev=2.0**-25,
        ks_decomp_length=8,
        ks_log2_base=2,
        ks_noise_stddev=2.0**-15,
        max_parties=1,
    )
