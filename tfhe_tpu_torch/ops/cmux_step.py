"""The dense depth-0 CMUX step and its rotation: plain torch versions, CUDA
kernel wrappers, and the dispatchers between them.

Counterpart of `cmux_step_pallas` of `tfhe_tpu/ops/pallas_cmux.py`, with its
two kernels `_rotate_decompose_kernel` and `_cmux_matmul_kernel`, and of
`mux_rotate_baked` of `tfhe_tpu/bootstrap.py`. The key is
`conv.bake_block_toeplitz`'s int8[n, 2M*P*T, K*4*T], block shifts stored
permuted so that output block o reads the contiguous rows
[(M-1-o)*P*T, (2M-1-o)*P*T). The plain versions read it so; the kernels
read it K-major, int8[n, K, 4, T, 2M*P*T] (`dots.to_kmajor`, the layout a
key takes on the card), and raise on the reference layout.

* `rotate_decompose_plain`, `cmux_matmul_plain`, `cmux_step_plain`: the two
  halves of a step, and the step, in torch ops. `mux_rotate_baked` is the
  reference's own formulation of the step (2M-1 matmuls); the two agree.
* `rotate_decompose_kernel`, `cmux_matmul_kernel`, `cmux_step_kernel`: the
  CUDA wrappers (`csrc/cmux_step.cu`); each counts its launches
  (`instrument` counters named as in `ops.kernel_wrappers()`).
* `blind_rotate_dense_plain` / `blind_rotate_dense_kernel`: the n steps in
  a loop on one stream, as the reference scans `cmux_step_pallas`.
* `cmux_step`, `blind_rotate_dense`: CPU tensors take the plain version;
  CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ..instrument import cached_build, count, span
from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from . import dots
from .blind_rotate import raise_on_error, require, rotation_launch
from .conv import (
    block_toeplitz_matmul,
    i8_matmul,
    recombine_block_prods,
    split_small_limbs,
)


def digit_limb_shifts(log2_base: int) -> tuple:
    """The shifts `split_small_limbs` gives digits of this base: (0,) up to
    2^8, (0, 4) above."""
    return (0,) if log2_base <= 8 else (0, 4)


def dense_product_tables(m: int, d_shifts: tuple) -> tuple:
    """The dense step as the dots kernel's products (see
    `blind_rotate.product_tables`): the digit operand has S*M segments of
    P*T bytes, limb s of block i at segment s*M + i; output block o gets,
    per digit limb, one product over M segments against key segments
    [M-1-o, 2M-1-o), its one target (o, +1). No product repeats."""
    return tuple((s * m, m - 1 - o, m, shift, ((o, 1),))
                 for o in range(m) for s, shift in enumerate(d_shifts))


@cached_build("dense_dots_tables")
def _dense_dots_tables(k1: int, l: int, m: int, d_shifts: tuple,
                       t: int) -> dots.DotsTables:
    return dots.encode_single_key(dense_product_tables(m, d_shifts), k1, m,
                                  k1 * l * t)


# --- plain versions ---


def mux_rotate_baked(acc_a: torch.Tensor, e_i: torch.Tensor,
                     barai: torch.Tensor, decomp_length: int, log2_base: int,
                     block: int, balanced: bool = False) -> torch.Tensor:
    """One CMUX against a dense block-Toeplitz key step:
    acc += BK_i (x) [(X^bara_i - 1) * acc].

    acc_a: int32[B, k+1, N]; e_i: int8[2M*P*T, K*4*T]; barai: int32[B].
    Branchless: bara_i == 0 gives all-zero digits.
    """
    b_sz, kp1, n = acc_a.shape
    rot = mul_by_monomial(acc_a, barai[:, None])
    digits = decompose(rot - acc_a, decomp_length, log2_base, balanced)
    digits = digits.reshape(b_sz, kp1 * decomp_length, n)
    d_limbs, d_shifts = split_small_limbs(digits, log2_base - 1)
    prods = block_toeplitz_matmul(d_limbs, e_i, block)
    return acc_a + recombine_block_prods(prods, kp1, d_shifts)


def rotate_decompose_plain(bara: torch.Tensor, acc: torch.Tensor, *, l: int,
                           b: int, t: int, balanced: bool) -> torch.Tensor:
    """Digit limbs of (X^bara - 1) * acc: bara int32[B], acc int32[B, K, N]
    -> int8[S, B, M*P*T], lane order (block i, poly j, level, coeff)."""
    bsz, k1, n = acc.shape
    m = n // t
    rot = mul_by_monomial(acc, bara[:, None])
    digits = decompose(rot - acc, l, b, balanced).reshape(bsz, k1 * l, n)
    d_limbs, _ = split_small_limbs(digits, b - 1)  # [S, B, P, N]
    s = d_limbs.shape[0]
    d_limbs = d_limbs.reshape(s, bsz, k1 * l, m, t).permute(0, 1, 3, 2, 4)
    return d_limbs.reshape(s, bsz, m * k1 * l * t)


def cmux_matmul_plain(digits: torch.Tensor, acc: torch.Tensor,
                      e_step: torch.Tensor, *, l: int, b: int,
                      t: int) -> torch.Tensor:
    """acc + recombine(digits (x) e_step): per output block one int8 dot of
    digits int8[S, B, M*P*T] against the block's key window. Returns
    int32[B, K, N]."""
    bsz, k1, n = acc.shape
    m = n // t
    mpt = m * k1 * l * t
    d_shifts = digit_limb_shifts(b)
    out = acc.clone()
    for o in range(m):
        start = (m - 1 - o) * (mpt // m)
        window = e_step[start:start + mpt]
        for s, d_shift in enumerate(d_shifts):
            prod = i8_matmul(digits[s], window).reshape(bsz, k1, 4, t)
            for limb in range(4):
                out[:, :, o * t:(o + 1) * t] += \
                    prod[:, :, limb] << (d_shift + 8 * limb)
    return out


def cmux_step_plain(acc: torch.Tensor, e_step: torch.Tensor,
                    bara: torch.Tensor, *, l: int, b: int, t: int,
                    balanced: bool) -> torch.Tensor:
    """One dense CMUX step as its two halves; equal to `mux_rotate_baked`."""
    digits = rotate_decompose_plain(bara, acc, l=l, b=b, t=t,
                                    balanced=balanced)
    return cmux_matmul_plain(digits, acc, e_step, l=l, b=b, t=t)


def blind_rotate_dense_plain(acc: torch.Tensor, e_all: torch.Tensor,
                             bara_t: torch.Tensor, *, l: int, b: int, t: int,
                             balanced: bool) -> torch.Tensor:
    """Whole blind rotation against the dense key in torch ops: acc
    int32[B, K, N]; e_all int8[n, 2M*P*T, K*4*T]; bara_t int32[n, B]."""
    for s in range(e_all.shape[0]):
        acc = mux_rotate_baked(acc, e_all[s], bara_t[s], l, b, t, balanced)
    return acc


# --- kernel wrappers ---


def _dense_launch(who, acc, key, bara_t, l, b, t, balanced=False, lhs=None,
                  calls=1):
    """`rotation_launch` for the dense step: no Karatsuba plan, the digit
    row S*M segments (the S digit limbs of M blocks, no combos), the dense
    product table; raises unless the digits fit two int8 limbs."""
    require(b <= 11, f"gadget l={l}, b={b} does not fit 32-bit words and "
            "two int8 digit limbs", who)
    m, s_limbs = acc.shape[-1] // t, len(digit_limb_shifts(b))
    return rotation_launch(
        who, acc, key, bara_t, l=l, b=b, t=t,
        offset=decomp_offset(l, b, balanced), combos=((), s_limbs * m),
        tables=None if key is None else lambda: _dense_dots_tables(
            acc.shape[1], l, m, digit_limb_shifts(b), t),
        lhs=lhs, calls=calls)


def rotate_decompose_kernel(bara: torch.Tensor, acc: torch.Tensor, *, l: int,
                            b: int, t: int, balanced: bool) -> torch.Tensor:
    """`rotate_decompose_plain` through the CUDA kernel. The result
    int8[S, B, M*P*T] is a view of a buffer laid out [B, S, M*P*T], the
    layout `cmux_matmul_kernel` reads without a copy."""
    who = "rotate_decompose_kernel"
    run = _dense_launch(who, acc, None, bara[None], l, b, t, balanced)
    if run.sizes.batch:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_rotate_decompose(
                acc.data_ptr(), bara.data_ptr(), run.lhs.data_ptr(),
                run.sizes, run.stream)
        raise_on_error(who, run.lib, err)
        count("rotate_decompose")
    return run.lhs.view(run.sizes.batch, len(digit_limb_shifts(b)),
                        run.sizes.m * run.pt).permute(1, 0, 2)


def cmux_matmul_kernel(digits: torch.Tensor, acc: torch.Tensor,
                       e_step: torch.Tensor, *, l: int, b: int,
                       t: int) -> torch.Tensor:
    """`cmux_matmul_plain` through the CUDA dots kernel driven by the dense
    product table; e_step K-major, int8[K, 4, T, 2M*P*T]."""
    who = "cmux_matmul_kernel"
    run = _dense_launch(who, acc, e_step[None], None, l, b, t, lhs=digits)
    bsz, k1, m = run.sizes.batch, run.sizes.k1, run.sizes.m
    shape = (len(digit_limb_shifts(b)), bsz, m * run.pt)
    require(digits.device == acc.device and digits.dtype == torch.int8
            and tuple(digits.shape) == shape,
            f"digits must be int8{list(shape)} on {acc.device}, got "
            f"{digits.dtype}{list(digits.shape)} on {digits.device}", who)
    dots.require_kmajor(who, e_step, (), k1, t, 2 * m * run.pt)
    buf = digits.permute(1, 0, 2).contiguous()  # no copy for the kernel's own
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_cmux_matmul(
                run.out.data_ptr(), buf.data_ptr(), e_step.data_ptr(),
                run.sizes, run.dots, run.stream)
        raise_on_error(who, run.lib, err)
        count("cmux_matmul")
    return run.out


def cmux_step_kernel(acc: torch.Tensor, e_step: torch.Tensor,
                     bara: torch.Tensor, *, l: int, b: int, t: int,
                     balanced: bool) -> torch.Tensor:
    """One dense CMUX step through the two CUDA kernels."""
    digits = rotate_decompose_kernel(bara, acc, l=l, b=b, t=t,
                                     balanced=balanced)
    return cmux_matmul_kernel(digits, acc, e_step, l=l, b=b, t=t)


def cmux_step(acc: torch.Tensor, e_step: torch.Tensor, bara: torch.Tensor, *,
              l: int, b: int, t: int, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernels."""
    fn = cmux_step_kernel if acc.is_cuda else cmux_step_plain
    return fn(acc, e_step, bara, l=l, b=b, t=t, balanced=balanced)


def blind_rotate_dense_kernel(acc: torch.Tensor, e_all: torch.Tensor,
                              bara_t: torch.Tensor, *, l: int, b: int, t: int,
                              balanced: bool) -> torch.Tensor:
    """Whole blind rotation against the dense key, K-major
    (int8[n, K, 4, T, 2M*P*T]): the two kernels of the step, n times on
    the current stream, the accumulator updated in place in one copy of
    `acc`. Does not synchronise."""
    who = "blind_rotate_dense_kernel"
    n_steps = e_all.shape[0]
    run = _dense_launch(who, acc, e_all, bara_t, l, b, t, balanced,
                        calls=n_steps)
    dots.require_kmajor(who, e_all, (n_steps,), run.sizes.k1, t,
                        2 * run.sizes.m * run.pt)
    if run.dots is None:
        return run.out
    for s in range(n_steps):
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_rotate_decompose(
                run.out.data_ptr(), bara_t[s].data_ptr(), run.lhs.data_ptr(),
                run.sizes, run.stream)
        raise_on_error("rotate_decompose_kernel", run.lib, err)
        count("rotate_decompose")
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_cmux_matmul(
                run.out.data_ptr(), run.lhs.data_ptr(), e_all[s].data_ptr(),
                run.sizes, run.dots, run.stream)
        raise_on_error("cmux_matmul_kernel", run.lib, err)
        count("cmux_matmul")
    return run.out


def blind_rotate_dense(acc: torch.Tensor, e_all: torch.Tensor,
                       bara_t: torch.Tensor, *, l: int, b: int, t: int,
                       balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernels."""
    fn = blind_rotate_dense_kernel if acc.is_cuda else blind_rotate_dense_plain
    return fn(acc, e_all, bara_t, l=l, b=b, t=t, balanced=balanced)
