"""Gate bootstrapping: modulus switch -> blind rotate -> extract -> keyswitch.

Counterpart of `tfhe_tpu/bootstrap.py`, baked block-Karatsuba key only.
The n CMUX steps are branchless: when bara_i == 0 the rotated accumulator
equals the accumulator, its digits are all zero, and the step adds exactly
zero. On a CUDA device the whole rotation is one call of the hand-written
kernel (ops/blind_rotate.py); on the CPU it is the plain torch loop.
"""

from __future__ import annotations

import dataclasses

import torch

from . import polynomial
from .keyswitch import KeyswitchKey, keyswitch
from .lwe import LweSample
from .noise import blind_rotate_var
from .numeric import decode_message
from .ops.blind_rotate import blind_rotate_baked, mux_rotate_karatsuba  # noqa: F401
from .ops.karatsuba import KaratsubaPlan, bake_karatsuba, karatsuba_plan
from .tgsw import prepare_tgsw, tgsw_encrypt
from .tlwe import TLweSample, tlwe_extract_sample, tlwe_noiseless_trivial

# Karatsuba depth for new bootstrap keys, clamped to log2(N/T) like the
# reference's default.
KARATSUBA_DEPTH = 2


def default_block(poly_degree: int) -> int:
    """Toeplitz block size T: 128 when N allows it (the CUDA kernel takes
    T = 128 only), else the largest power of two with N/T >= 2."""
    if poly_degree % 128 == 0:
        return 128
    for t in (64, 32, 16, 8, 4, 2, 1):
        if poly_degree % t == 0 and poly_degree // t >= 2:
            return t
    return 1


@dataclasses.dataclass(frozen=True)
class BootstrapKey:
    """TGSW encryptions of the LWE key bits, baked for the Karatsuba
    contraction: baked int8[n, total_rows*P*T, (k+1)*4*T]
    (ops/karatsuba.py:bake_karatsuba)."""

    baked: torch.Tensor
    decomp_length: int
    log2_base: int
    polynomial_degree: int
    mask_size: int
    block: int
    depth: int
    noise_stddev: float = 0.0
    balanced: bool = False

    @property
    def n(self) -> int:
        return self.baked.shape[0]

    @property
    def plan(self) -> KaratsubaPlan:
        return karatsuba_plan(self.polynomial_degree // self.block,
                              self.depth, self.log2_base)


def bootstrap_key_from_raw(gsw: torch.Tensor, decomp_length: int,
                           log2_base: int, block: int | None = None,
                           depth: int | None = None,
                           noise_stddev: float = 0.0,
                           balanced: bool = False) -> BootstrapKey:
    """Bake a key from raw TGSW samples gsw: int32[n, l, k+1, k+1, N]."""
    poly_degree = gsw.shape[-1]
    t = default_block(poly_degree) if block is None else block
    depth = KARATSUBA_DEPTH if depth is None else depth
    depth = min(depth, (poly_degree // t).bit_length() - 1)
    if depth == 0:
        raise NotImplementedError(
            "the dense depth-0 key (and N == T) is not ported yet: "
            "ROADMAP.md queue 1, items 6 and 7")
    plan = karatsuba_plan(poly_degree // t, depth, log2_base)
    limbs = prepare_tgsw(gsw, decomp_length, log2_base)  # [n, 4, P, K, 2N]
    baked = bake_karatsuba(limbs, t, plan)
    return BootstrapKey(baked, decomp_length, log2_base, poly_degree,
                        gsw.shape[-2] - 1, t, depth, noise_stddev, balanced)


def bootstrap_key_gen(generator: torch.Generator, alpha: float,
                      lwe_key: torch.Tensor, tlwe_key: torch.Tensor,
                      decomp_length: int, log2_base: int,
                      block: int | None = None,
                      balanced: bool = False) -> BootstrapKey:
    """TGSW-encrypt each bit of the LWE key under the TLWE key, then bake."""
    n = lwe_key.shape[0]
    gsw = tgsw_encrypt(generator, lwe_key, alpha, tlwe_key, decomp_length,
                       log2_base, batch_shape=(n,))
    return bootstrap_key_from_raw(gsw, decomp_length, log2_base, block,
                                  noise_stddev=alpha, balanced=balanced)


def blind_rotate(accum: TLweSample, bk: BootstrapKey,
                 bara: torch.Tensor) -> TLweSample:
    """Multiply the accumulator by X^{sum_i bara_i * s_i} via n CMUX steps.
    accum: [B, k+1, N]; bara: int32[B, n]."""
    bara_t = bara.to(torch.int32).transpose(0, 1).contiguous()  # [n, B]
    out_a = blind_rotate_baked(
        accum.a.contiguous(), bk.baked, bara_t, l=bk.decomp_length,
        b=bk.log2_base, t=bk.block, plan=bk.plan, balanced=bk.balanced)
    cv = accum.cv + blind_rotate_var(
        bk.n, bk.mask_size, bk.decomp_length, bk.log2_base,
        bk.polynomial_degree, bk.noise_stddev, bk.balanced)
    return TLweSample(out_a, cv)


def blind_rotate_and_extract(v: torch.Tensor, bk: BootstrapKey,
                             barb: torch.Tensor,
                             bara: torch.Tensor) -> LweSample:
    """LWE(v_p) with p = barb - sum(bara_i s_i) mod 2N.
    v: int32[B, N] test polynomial; barb: int32[B]; bara: int32[B, n]."""
    testvectbis = polynomial.mul_by_monomial(v, -barb.to(torch.int32))
    accum = tlwe_noiseless_trivial(testvectbis, bk.mask_size)
    return tlwe_extract_sample(blind_rotate(accum, bk, bara))


def bootstrap_wo_keyswitch(bk: BootstrapKey, mu: int,
                           x: LweSample) -> LweSample:
    """LWE(mu) iff phase(x) > 0 else LWE(-mu), in the extracted (k*N)-dim
    space. x: any batch shape [..., n]."""
    p_degree = bk.polynomial_degree
    batch_shape = x.b.shape
    flat_a = x.a.reshape(-1, x.a.shape[-1])
    flat_b = x.b.reshape(-1)
    bara = decode_message(flat_a, p_degree * 2)  # [B, n]: mod switch to 2N
    barb = decode_message(flat_b, p_degree * 2)  # [B]
    testvect = torch.full(flat_b.shape + (p_degree,), mu, dtype=torch.int32,
                          device=flat_b.device)
    out = blind_rotate_and_extract(testvect, bk, barb, bara)
    return LweSample(out.a.reshape(batch_shape + (out.a.shape[-1],)),
                     out.b.reshape(batch_shape), out.cv.reshape(batch_shape))


def bootstrap(bk: BootstrapKey, ks: KeyswitchKey, mu: int,
              x: LweSample) -> LweSample:
    """Full gate bootstrap: refresh the noise and return to the n-dim LWE
    space."""
    return keyswitch(ks, bootstrap_wo_keyswitch(bk, mu, x))
