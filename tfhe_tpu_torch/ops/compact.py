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
  kernel (`csrc/compact.cu`), in the reference layout or K-major;
  `expand_store_map` lists that kernel's stores, for the CPU tests.
* `blind_rotate_compact_kernel`: the whole rotation in one C call: per
  step the expansion kernel writes a scratch operand, K-major
  (`dots.to_kmajor`'s layout), that the step's rotate/decompose and dots
  launches read.
* `expand_step`, `blind_rotate_compact`: CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.

Each wrapper counts the C calls that launched its kernel (`instrument`
counters named as in `ops.kernel_wrappers()`); the compact rotation
launches the expansion kernel too, and counts it.
"""

from __future__ import annotations

import ctypes

import torch

from ..instrument import cached_build, count, span
from ..tgsw import decomp_offset
from . import dots
from .blind_rotate import (
    dots_tables,
    mux_rotate_karatsuba,
    raise_on_error,
    require,
    rotation_launch,
)
from .karatsuba import KaratsubaPlan, entry_rows, expand_karatsuba_step


def entry_masks(plan: KaratsubaPlan) -> list:
    """The expansion kernel's table: for each row of the baked layout (per
    leaf, entries reversed), the bit mask of the Toeplitz blocks it sums."""
    return [sum(1 << d for d in entry) for entry in entry_rows(plan)]


@cached_build("device_entry_masks")
def _device_entry_masks(plan: KaratsubaPlan, device: str) -> torch.Tensor:
    return dots.int_table([entry_masks(plan)], device)


def expand_store_map(total_rows: int, p_rows: int, k1: int, kmajor: bool,
                     t: int = 128):
    """The expansion kernel's work split and stores
    (csrc/cmux_kernels.cuh:expand_kernel): one block per unit (bake row r,
    key row pj, poly k, limb), in grid order, each storing T*T/16 lines of
    16 bytes taken from the unit's 2T limb bytes as the block keeps them
    (C forward for the reference layout, reversed for K-major). Returns
    int64 tensors (units [n, 4] of (r, pj, k, limb), dst [n, T*T/16] the
    byte offset of each store in the step's output, src [n, T*T/16] the
    first of the 16 kept bytes it takes)."""
    grid = torch.cartesian_prod(torch.arange(total_rows),
                                torch.arange(p_rows), torch.arange(k1),
                                torch.arange(4))
    r, pj, k, limb = (grid[:, i:i + 1] for i in range(4))
    x = torch.arange(t * t // 16)[None, :]
    line, v = x >> 3, x & 7  # 8 stores a 128-byte line
    row0 = (r * p_rows + pj) * t
    if kmajor:  # [k][limb][w = line][row0 + u]
        dst = ((k * 4 + limb) * t + line) * (total_rows * p_rows * t) \
            + row0 + 16 * v
        src = t - 1 - line + 16 * v
    else:  # [row0 + u = line][k][limb][w]
        dst = (row0 + line) * (k1 * 4 * t) + (k * 4 + limb) * t + 16 * v
        src = t - line + 16 * v
    return grid, dst, src.expand_as(dst)


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
                       plan: KaratsubaPlan,
                       kmajor: bool = False) -> torch.Tensor:
    """One step's expansion through the CUDA kernel; the same contract as
    `expand_step_plain`, or with `kmajor` its K-major layout
    int8[K, 4, T, R*P*T] (`dots.to_kmajor` of it). Launches on the current
    stream."""
    from . import _build

    who = "expand_step_kernel"
    require(limbs_step.is_cuda and limbs_step.dtype == torch.int8
            and limbs_step.is_contiguous() and limbs_step.dim() == 4,
            "needs a contiguous int8[4, P, K, 2N] CUDA tensor", who)
    _, p, k1, n2 = limbs_step.shape
    _check_limbs(who, limbs_step.shape, k1, n2 // 2, t, plan)
    lib = _build.load()
    masks = _device_entry_masks(plan, str(limbs_step.device))
    rows = plan.total_rows * p * t
    shape = (k1, 4, t, rows) if kmajor else (rows, k1 * 4 * t)
    out = torch.empty(shape, dtype=torch.int8, device=limbs_step.device)
    stream = torch.cuda.current_stream(limbs_step.device).cuda_stream
    with span("tfhe.enqueue"):
        err = lib.tfhe_expand_step(limbs_step.data_ptr(), masks.data_ptr(),
                                   out.data_ptr(), plan.total_rows, p, k1,
                                   n2 // 2, int(kmajor),
                                   ctypes.c_void_p(stream))
    raise_on_error(who, lib, err)
    count("expand_karatsuba_step")
    return out


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
    who = "blind_rotate_compact_kernel"
    run = rotation_launch(
        who, acc, limbs, bara_t, l=l, b=b, t=t,
        offset=decomp_offset(l, b, balanced), plan=plan,
        tables=lambda: dots_tables(plan, acc.shape[1], l, t))
    k1, n = run.sizes.k1, run.sizes.n
    require(limbs.dim() == 5 and limbs.shape[2] == k1 * l,
            f"compact key shape {tuple(limbs.shape)} does not fit l={l}", who)
    _check_limbs(who, limbs.shape[1:], k1, n, t, plan)
    n_steps = limbs.shape[0]
    masks = _device_entry_masks(plan, str(acc.device))
    scratch = torch.empty((k1, 4, t, plan.total_rows * run.pt),
                          dtype=torch.int8, device=acc.device)  # K-major
    if run.dots is not None:
        with span("tfhe.enqueue"):
            err = run.lib.tfhe_blind_rotate_compact(
                run.out.data_ptr(), limbs.data_ptr(), bara_t.data_ptr(),
                run.lhs.data_ptr(), scratch.data_ptr(), masks.data_ptr(),
                run.sizes, run.dots, n_steps, run.stream)
        raise_on_error(who, run.lib, err)
        count("blind_rotate_compact")
        count("expand_karatsuba_step")
        count("rotate_decompose_rows", n_steps)
    return run.out


def blind_rotate_compact(acc: torch.Tensor, limbs: torch.Tensor,
                         bara_t: torch.Tensor, *, l: int, b: int, t: int,
                         plan: KaratsubaPlan, balanced: bool) -> torch.Tensor:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    fn = (blind_rotate_compact_kernel if acc.is_cuda
          else blind_rotate_compact_plain)
    return fn(acc, limbs, bara_t, l=l, b=b, t=t, plan=plan, balanced=balanced)
