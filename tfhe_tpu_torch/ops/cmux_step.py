"""The dense depth-0 CMUX step and its rotation: plain torch versions, CUDA
kernel wrappers, and the dispatchers between them.

Counterpart of `cmux_step_pallas` of `tfhe_tpu/ops/pallas_cmux.py`, with its
two kernels `_rotate_decompose_kernel` and `_cmux_matmul_kernel`, and of
`mux_rotate_baked` of `tfhe_tpu/bootstrap.py`. The key is
`conv.bake_block_toeplitz`'s int8[n, 2M*P*T, K*4*T], block shifts stored
permuted so that output block o reads the contiguous rows
[(M-1-o)*P*T, (2M-1-o)*P*T).

* `rotate_decompose_plain`, `cmux_matmul_plain`, `cmux_step_plain`: the two
  halves of a step, and the step, in torch ops. `mux_rotate_baked` is the
  reference's own formulation of the step (2M-1 matmuls); the two agree.
* `rotate_decompose_kernel`, `cmux_matmul_kernel`, `cmux_step_kernel`: the
  CUDA wrappers (`csrc/cmux_step.cu`); each counts its launches in
  `.launches`.
* `blind_rotate_dense_plain` / `blind_rotate_dense_kernel`: the n steps in
  a loop on one stream, as the reference scans `cmux_step_pallas`.
* `cmux_step`, `blind_rotate_dense`: CPU tensors take the plain version;
  CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..polynomial import mul_by_monomial
from ..tgsw import decomp_offset, decompose
from .blind_rotate import KERNEL_BLOCK, int_table, raise_on_error, require
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


def dense_tables(m: int, d_shifts: tuple):
    """The dense step as the dots kernel's term table (see
    `blind_rotate.kernel_tables`): the digit operand has S*M segments of
    P*T bytes, limb s of block i at segment s*M + i; output block o gets,
    per digit limb, one term over M segments against key segments
    [M-1-o, 2M-1-o), sign +1. Returns (terms, term_start)."""
    terms = [(o, s * m, m - 1 - o, m, shift, 1)
             for o in range(m) for s, shift in enumerate(d_shifts)]
    term_start = [o * len(d_shifts) for o in range(m + 1)]
    return terms, term_start


@functools.lru_cache(maxsize=None)
def _device_dense_tables(m: int, d_shifts: tuple, device: str):
    terms, term_start = dense_tables(m, d_shifts)
    return int_table(terms, device), int_table([term_start], device)


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


def _dims(who: str, acc: torch.Tensor, l: int, b: int, t: int):
    require(acc.is_cuda and acc.dtype == torch.int32 and acc.is_contiguous()
            and acc.dim() == 3,
            "acc must be a contiguous int32[B, K, N] CUDA tensor", who)
    require(t == KERNEL_BLOCK, f"block T must be {KERNEL_BLOCK}, got {t}",
            who)
    require(1 <= b <= 11 and l * b <= 32,
            f"gadget l={l}, b={b} does not fit 32-bit words and two int8 "
            "digit limbs", who)
    bsz, k1, n = acc.shape
    require(n % t == 0 and n & (n - 1) == 0,
            f"N={n} must be a power of two and a multiple of T", who)
    return bsz, k1, n, n // t, len(digit_limb_shifts(b))


def _on_device(who: str, x: torch.Tensor, ref: torch.Tensor, dtype, shape,
               name: str):
    require(x.device == ref.device and x.dtype == dtype
            and tuple(x.shape) == tuple(shape),
            f"{name} must be {dtype}{list(shape)} on {ref.device}, got "
            f"{x.dtype}{list(x.shape)} on {x.device}", who)


def _launch_rotate_decompose(lib, acc, bara, buf, dims, l, b, offset):
    bsz, k1, n, m, s_limbs = dims
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    err = lib.tfhe_rotate_decompose(
        acc.data_ptr(), bara.data_ptr(), buf.data_ptr(), bsz, k1, n, l, b, m,
        s_limbs, offset, ctypes.c_void_p(stream))
    raise_on_error("rotate_decompose_kernel", lib, err)
    rotate_decompose_kernel.launches += 1


def _launch_cmux_matmul(lib, acc, buf, e_step, dims, l, b):
    bsz, k1, n, m, s_limbs = dims
    terms, term_start = _device_dense_tables(m, digit_limb_shifts(b),
                                             str(acc.device))
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    err = lib.tfhe_cmux_matmul(
        acc.data_ptr(), buf.data_ptr(), e_step.data_ptr(), terms.data_ptr(),
        term_start.data_ptr(), bsz, k1, n, l, b, m, s_limbs,
        ctypes.c_void_p(stream))
    raise_on_error("cmux_matmul_kernel", lib, err)
    cmux_matmul_kernel.launches += 1


def rotate_decompose_kernel(bara: torch.Tensor, acc: torch.Tensor, *, l: int,
                            b: int, t: int, balanced: bool) -> torch.Tensor:
    """`rotate_decompose_plain` through the CUDA kernel. The result
    int8[S, B, M*P*T] is a view of a buffer laid out [B, S, M*P*T], the
    layout `cmux_matmul_kernel` reads without a copy."""
    from . import _build

    who = "rotate_decompose_kernel"
    dims = _dims(who, acc, l, b, t)
    bsz, k1, n, m, s_limbs = dims
    _on_device(who, bara, acc, torch.int32, (bsz,), "bara")
    require(bara.is_contiguous(), "bara must be contiguous", who)
    buf = torch.empty((bsz, s_limbs, m * k1 * l * t), dtype=torch.int8,
                      device=acc.device)
    if bsz:
        _launch_rotate_decompose(_build.load(), acc, bara, buf, dims, l, b,
                                 decomp_offset(l, b, balanced))
    return buf.permute(1, 0, 2)


rotate_decompose_kernel.launches = 0


def cmux_matmul_kernel(digits: torch.Tensor, acc: torch.Tensor,
                       e_step: torch.Tensor, *, l: int, b: int,
                       t: int) -> torch.Tensor:
    """`cmux_matmul_plain` through the CUDA dots kernel driven by the dense
    term table."""
    from . import _build

    who = "cmux_matmul_kernel"
    dims = _dims(who, acc, l, b, t)
    bsz, k1, n, m, s_limbs = dims
    pt = k1 * l * t
    _on_device(who, digits, acc, torch.int8, (s_limbs, bsz, m * pt), "digits")
    _on_device(who, e_step, acc, torch.int8, (2 * m * pt, k1 * 4 * t),
               "e_step")
    require(e_step.is_contiguous(), "e_step must be contiguous", who)
    buf = digits.permute(1, 0, 2).contiguous()  # no copy for the kernel's own
    out = acc.clone()
    if bsz:
        _launch_cmux_matmul(_build.load(), out, buf, e_step, dims, l, b)
    return out


cmux_matmul_kernel.launches = 0


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
    """Whole blind rotation against the dense key: the two kernels of the
    step, n times on the current stream, the accumulator updated in place
    in one copy of `acc`. Does not synchronise."""
    from . import _build

    who = "blind_rotate_dense_kernel"
    dims = _dims(who, acc, l, b, t)
    bsz, k1, n, m, s_limbs = dims
    pt = k1 * l * t
    n_steps = e_all.shape[0]
    _on_device(who, e_all, acc, torch.int8,
               (n_steps, 2 * m * pt, k1 * 4 * t), "e_all")
    _on_device(who, bara_t, acc, torch.int32, (n_steps, bsz), "bara_t")
    require(e_all.is_contiguous() and bara_t.is_contiguous(),
            "tensors must be contiguous", who)
    out = acc.clone()
    if not (n_steps and bsz):
        return out
    lib = _build.load()
    offset = decomp_offset(l, b, balanced)
    buf = torch.empty((bsz, s_limbs, m * pt), dtype=torch.int8,
                      device=acc.device)
    for s in range(n_steps):
        _launch_rotate_decompose(lib, out, bara_t[s], buf, dims, l, b, offset)
        _launch_cmux_matmul(lib, out, buf, e_all[s], dims, l, b)
    return out


def blind_rotate_dense(acc: torch.Tensor, e_all: torch.Tensor,
                       bara_t: torch.Tensor, *, l: int, b: int, t: int,
                       balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernels."""
    fn = blind_rotate_dense_kernel if acc.is_cuda else blind_rotate_dense_plain
    return fn(acc, e_all, bara_t, l=l, b=b, t=t, balanced=balanced)
