"""The blind rotation from the compact (prepared-limb) key: plain torch
version, CUDA kernel wrappers, and the dispatcher between them.

Counterpart of `blind_rotate_pallas_compact` (`_compact_megakernel`) of
`tfhe_tpu/ops/pallas_cmux.py`. The key is `prepare_tgsw`'s
int8[n, 4, P, K, 2N]; each step's Karatsuba operand is expanded from it at
gate time, byte-equal to that step of `bake_karatsuba`, and the step then
runs as in `ops/blind_rotate.py`.

* `expand_step_plain` / `blind_rotate_compact_plain`: torch ops
  (`karatsuba.expand_karatsuba_step`, then `mux_rotate_karatsuba`). The CPU
  path and the oracle for the kernels.
* `expand_step_kernel`: one step's expansion through the CUDA expansion
  kernel (`csrc/compact.cu`).
* `blind_rotate_compact_kernel`: the whole rotation in one C call: per
  step the expansion kernel writes a scratch operand that the step's
  rotate/decompose and dots launches read.
* `expand_step`, `blind_rotate_compact`: CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.

Each wrapper counts the C calls that launched its kernel in `.launches`;
the compact rotation launches the expansion kernel too, and counts it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..tgsw import decomp_offset
from .blind_rotate import (
    check_rotation_args,
    device_tables,
    int_table,
    mux_rotate_karatsuba,
    raise_on_error,
    require,
)
from .karatsuba import KaratsubaPlan, entry_rows, expand_karatsuba_step


def entry_masks(plan: KaratsubaPlan) -> list:
    """The expansion kernel's table: for each row of the baked layout (per
    leaf, entries reversed), the bit mask of the Toeplitz blocks it sums."""
    return [sum(1 << d for d in entry) for entry in entry_rows(plan)]


@functools.lru_cache(maxsize=None)
def _device_entry_masks(plan: KaratsubaPlan, device: str) -> torch.Tensor:
    return int_table([entry_masks(plan)], device)


def expand_step_plain(limbs_step: torch.Tensor, *, t: int,
                      plan: KaratsubaPlan) -> torch.Tensor:
    """int8[4, P, K, 2N] -> int8[total_rows*P*T, K*4*T] in torch ops."""
    return expand_karatsuba_step(limbs_step, t, plan)


def _check_limbs(who: str, limbs_step_shape, k1: int, n: int, t: int,
                 plan: KaratsubaPlan):
    p = limbs_step_shape[1]
    require(tuple(limbs_step_shape) == (4, p, k1, 2 * n),
            f"compact key step has shape {tuple(limbs_step_shape)}, "
            f"expected (4, P, {k1}, {2 * n})", who)
    require(t == 128 and n % t == 0 and n & (n - 1) == 0
            and plan.m == n // t and plan.m <= 31,
            f"T must be 128 and N={n} a power of two with plan.m = N/T <= 31",
            who)


def expand_step_kernel(limbs_step: torch.Tensor, *, t: int,
                       plan: KaratsubaPlan) -> torch.Tensor:
    """One step's expansion through the CUDA kernel; the same contract as
    `expand_step_plain`. Launches on the current stream."""
    from . import _build

    who = "expand_step_kernel"
    require(limbs_step.is_cuda and limbs_step.dtype == torch.int8
            and limbs_step.is_contiguous() and limbs_step.dim() == 4,
            "needs a contiguous int8[4, P, K, 2N] CUDA tensor", who)
    _, p, k1, n2 = limbs_step.shape
    _check_limbs(who, limbs_step.shape, k1, n2 // 2, t, plan)
    lib = _build.load()
    masks = _device_entry_masks(plan, str(limbs_step.device))
    out = torch.empty((plan.total_rows * p * t, k1 * 4 * t), dtype=torch.int8,
                      device=limbs_step.device)
    stream = torch.cuda.current_stream(limbs_step.device).cuda_stream
    err = lib.tfhe_expand_step(limbs_step.data_ptr(), masks.data_ptr(),
                               out.data_ptr(), plan.total_rows, p, k1,
                               n2 // 2, ctypes.c_void_p(stream))
    raise_on_error(who, lib, err)
    expand_step_kernel.launches += 1
    return out


expand_step_kernel.launches = 0


def expand_step(limbs_step: torch.Tensor, *, t: int,
                plan: KaratsubaPlan) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = expand_step_kernel if limbs_step.is_cuda else expand_step_plain
    return fn(limbs_step, t=t, plan=plan)


def blind_rotate_compact_plain(acc: torch.Tensor, limbs: torch.Tensor,
                               bara_t: torch.Tensor, *, l: int, b: int,
                               t: int, plan: KaratsubaPlan,
                               balanced: bool) -> torch.Tensor:
    """Whole blind rotation from the compact key in torch ops: acc
    int32[B, K, N]; limbs int8[n, 4, P, K, 2N]; bara_t int32[n, B]. Returns
    the rotated accumulator, int32[B, K, N]."""
    for s in range(limbs.shape[0]):
        e_step = expand_step_plain(limbs[s], t=t, plan=plan)
        acc = mux_rotate_karatsuba(acc, e_step, bara_t[s], l, b, t, plan,
                                   balanced)
    return acc


def blind_rotate_compact_kernel(acc: torch.Tensor, limbs: torch.Tensor,
                                bara_t: torch.Tensor, *, l: int, b: int,
                                t: int, plan: KaratsubaPlan,
                                balanced: bool) -> torch.Tensor:
    """Whole blind rotation from the compact key through the CUDA kernels;
    the same contract as `blind_rotate_compact_plain`. Takes T = 128 only.
    Launches on the current stream and does not synchronise."""
    from . import _build

    who = "blind_rotate_compact_kernel"
    bsz, k1, n, m, pt = check_rotation_args(who, acc, limbs, bara_t, l, b, t,
                                            plan)
    require(limbs.dim() == 5 and limbs.shape[2] == k1 * l,
            f"compact key shape {tuple(limbs.shape)} does not fit l={l}", who)
    _check_limbs(who, limbs.shape[1:], k1, n, t, plan)
    n_steps = limbs.shape[0]

    lib = _build.load()
    device = str(acc.device)
    combos, n_combos, terms, term_start, lhs_rows = device_tables(
        plan, k1 * l, t, device)
    masks = _device_entry_masks(plan, device)
    out = acc.clone()
    lhs = torch.empty((bsz, lhs_rows * pt), dtype=torch.int8,
                      device=acc.device)
    scratch = torch.empty((plan.total_rows * pt, k1 * 4 * t),
                          dtype=torch.int8, device=acc.device)
    if n_steps and bsz:
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.tfhe_blind_rotate_compact(
            out.data_ptr(), limbs.data_ptr(), bara_t.data_ptr(),
            lhs.data_ptr(), scratch.data_ptr(), masks.data_ptr(),
            combos.data_ptr(), n_combos, terms.data_ptr(),
            term_start.data_ptr(), bsz, k1, n, l, b, m, n_steps, lhs_rows,
            plan.total_rows, decomp_offset(l, b, balanced),
            ctypes.c_void_p(stream))
        raise_on_error(who, lib, err)
        blind_rotate_compact_kernel.launches += 1
        expand_step_kernel.launches += 1
    return out


blind_rotate_compact_kernel.launches = 0


def blind_rotate_compact(acc: torch.Tensor, limbs: torch.Tensor,
                         bara_t: torch.Tensor, *, l: int, b: int, t: int,
                         plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = (blind_rotate_compact_kernel if acc.is_cuda
          else blind_rotate_compact_plain)
    return fn(acc, limbs, bara_t, l=l, b=b, t=t, plan=plan, balanced=balanced)
