"""Gate bootstrapping: modulus switch -> blind rotate -> extract -> keyswitch.

Counterpart of `tfhe_tpu/bootstrap.py` for the three single-key forms of the
bootstrap key: Karatsuba-baked, dense depth-0, and compact (prepared limbs,
expanded per step at gate time). `tuning.karatsuba_depth` and
`tuning.bs_bake_budget` choose the form at keygen, as in the reference. The
n CMUX steps are branchless: when bara_i == 0 the rotated accumulator
equals the accumulator, its digits are all zero, and the step adds exactly
zero. On a CUDA device each form's rotation runs through hand-written
kernels (ops/blind_rotate.py, ops/compact.py, ops/cmux_step.py); on the CPU
it is the plain torch loop of the same module.
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
from .ops.cmux_step import blind_rotate_dense, mux_rotate_baked  # noqa: F401
from .ops.compact import blind_rotate_compact
from .ops.conv import bake_block_toeplitz
from .ops.karatsuba import KaratsubaPlan, bake_karatsuba, karatsuba_plan
from .tgsw import prepare_tgsw, tgsw_encrypt, tgsw_extern_mul_prepared
from .tlwe import TLweSample, tlwe_extract_sample, tlwe_noiseless_trivial
from .tuning import get_tuning


def default_block(poly_degree: int) -> int:
    """Toeplitz block size T: 128 when N allows it (the CUDA kernels take
    T = 128 only), else the largest power of two with N/T >= 2. N = 128
    gives M = 1: one full negacyclic Toeplitz block per polynomial, a
    depth-0 single-leaf plan (the 128_fast8 geometry)."""
    if poly_degree % 128 == 0:
        return 128
    for t in (64, 32, 16, 8, 4, 2, 1):
        if poly_degree % t == 0 and poly_degree // t >= 2:
            return t
    return 1


@dataclasses.dataclass(frozen=True)
class BootstrapKey:
    """TGSW encryptions of the LWE key bits, in one of three forms
    (P = (k+1)*l, T = block, M = N/T):

    * depth >= 1: baked for the Karatsuba contraction,
      int8[n, total_rows*P*T, (k+1)*4*T] (ops/karatsuba.py:bake_karatsuba);
    * depth == 0: the dense block-Toeplitz bake,
      int8[n, 2M*P*T, (k+1)*4*T] (ops/conv.py:bake_block_toeplitz);
    * compact: `baked` holds the prepared limbs int8[n, 4, P, k+1, 2N]
      (tgsw.prepare_tgsw), about T/2 times smaller than a bake, and the
      rotation expands each step's operand at gate time; `block` and
      `depth` then describe that expansion. The form for many tenants on
      one card (`tuning.bs_bake_budget`).
    """

    baked: torch.Tensor
    decomp_length: int
    log2_base: int
    polynomial_degree: int
    mask_size: int
    block: int
    depth: int
    noise_stddev: float = 0.0
    balanced: bool = False
    compact: bool = False

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
    """Build a key from raw TGSW samples gsw: int32[n, l, k+1, k+1, N].
    depth defaults to `tuning.karatsuba_depth`, clamped to log2(N/T);
    `tuning.bs_bake_budget` keeps the compact form when the bake would
    not fit (0: always)."""
    poly_degree = gsw.shape[-1]
    k1 = gsw.shape[-2]
    t = default_block(poly_degree) if block is None else block
    depth = get_tuning().karatsuba_depth if depth is None else depth
    depth = min(depth, (poly_degree // t).bit_length() - 1)
    limbs = prepare_tgsw(gsw, decomp_length, log2_base)  # [n, 4, P, K, 2N]
    meta = (decomp_length, log2_base, poly_degree, k1 - 1, t, depth,
            noise_stddev, balanced)
    budget = get_tuning().bs_bake_budget
    if budget >= 0:
        rows = (karatsuba_plan(poly_degree // t, depth, log2_base).total_rows
                if depth else 2 * (poly_degree // t))
        baked_bytes = gsw.shape[0] * rows * k1 * decomp_length * t * k1 * 4 * t
        if budget == 0 or baked_bytes > budget:
            return BootstrapKey(limbs.contiguous(), *meta, compact=True)
    if depth:
        plan = karatsuba_plan(poly_degree // t, depth, log2_base)
        baked = bake_karatsuba(limbs, t, plan)
    else:
        baked = bake_block_toeplitz(limbs, t)
    return BootstrapKey(baked, *meta)


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
    l, b, t = bk.decomp_length, bk.log2_base, bk.block
    acc = accum.a.contiguous()
    bara_t = bara.to(torch.int32).transpose(0, 1).contiguous()  # [n, B]
    if bk.compact:
        # The expansion kernel takes every plan; on the CPU, as in the
        # reference, depth 0 with M > 1 has no expansion path and runs the
        # prepared external product step by step.
        if acc.is_cuda or bk.depth or bk.polynomial_degree == t:
            out_a = blind_rotate_compact(acc, bk.baked, bara_t, l=l, b=b,
                                         t=t, plan=bk.plan,
                                         balanced=bk.balanced)
        else:
            out_a = acc
            for limbs_i, bara_i in zip(bk.baked, bara_t):
                rot = polynomial.mul_by_monomial(out_a, bara_i[:, None])
                temp = TLweSample(rot - out_a, accum.cv)
                out_a = out_a + tgsw_extern_mul_prepared(
                    temp, limbs_i, l, b, bk.balanced).a
    elif bk.depth:
        out_a = blind_rotate_baked(acc, bk.baked, bara_t, l=l, b=b, t=t,
                                   plan=bk.plan, balanced=bk.balanced)
    else:
        out_a = blind_rotate_dense(acc, bk.baked, bara_t, l=l, b=b, t=t,
                                   balanced=bk.balanced)
    cv = accum.cv + blind_rotate_var(
        bk.n, bk.mask_size, l, b, bk.polynomial_degree, bk.noise_stddev,
        bk.balanced)
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
