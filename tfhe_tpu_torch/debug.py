"""Opt-in debug mode: invariant checks at the blind rotation's boundary.

Counterpart of `tfhe_tpu/debug.py`. A kernel that computes wrong words
(a race, a bad tile map) yields wrong ciphertexts, not errors. With
`TuningConfig.debug = True` (`TFHE_TPU_DEBUG=1`), `bootstrap.blind_rotate`:

* runs the rotation through its dispatcher (the CUDA wrappers on the card,
  the `*_plain` versions on the CPU) and through an independent path, the
  step-by-step CMUX loop of plain torch ops (`bootstrap.mux_rotate` for a
  compact key, `mux_rotate_karatsuba` or `mux_rotate_baked` on each step
  of a baked or dense key, read in the reference layout), and raises
  `FHEDebugError` on any differing word;
* checks the gadget decomposition's contract on a live operand: digits in
  [-B/2, B/2) and exact reconstruction to l*b bits;
* returns the loop's result, so that debug mode is also a safe mode.

The reference's independent path is its XLA engine; here it is the loop,
which costs about what the plain version does (PERF.md section 6). The
knob is in the job fingerprint (`tuning.RESULT_AFFECTING`), so a job
cannot resume with the checks dropped.
"""

from __future__ import annotations

import torch

from .tgsw import decompose, gadget_values


class FHEDebugError(AssertionError):
    """A kernel-boundary invariant failed under TFHE_TPU_DEBUG=1."""


def check_gadget_invariants(x: torch.Tensor, decomp_length: int,
                            log2_base: int, balanced: bool) -> None:
    """Raise FHEDebugError unless decompose's contract holds on x: every
    digit in [-B/2, B/2), and the digits reconstruct x to within the l*b-bit
    rounding bound (one ulp for the truncating gadget, half for the
    balanced one). int32 wraparound is arithmetic mod 2^32, so the error
    needs no widening."""
    digits = decompose(x, decomp_length, log2_base, balanced)  # [..., l, N]
    half = 1 << (log2_base - 1)
    bad_digits = int(torch.count_nonzero((digits < -half) | (digits >= half)))
    g = torch.tensor(gadget_values(decomp_length, log2_base),
                     dtype=torch.int32, device=x.device)
    rec = torch.sum(digits * g[:, None], dim=-2, dtype=torch.int32)
    err = x.to(torch.int32) - rec
    lb = decomp_length * log2_base
    bound = (1 << (32 - lb - 1)) if balanced else (1 << (32 - lb))
    bad_recon = int(torch.count_nonzero(torch.abs(err) > bound))
    if bad_digits or bad_recon:
        raise FHEDebugError(
            f"gadget invariant violated (l={decomp_length}, b={log2_base}, "
            f"balanced={balanced}): {bad_digits} digits outside [-B/2, B/2),"
            f" {bad_recon} coefficients reconstruct outside the {lb}-bit "
            "rounding bound")


def _loop_blind_rotate(acc: torch.Tensor, bk, bara_t: torch.Tensor,
                       cv: torch.Tensor) -> torch.Tensor:
    """The n CMUX steps one by one in plain torch ops, on acc's device."""
    from .bootstrap import mux_rotate
    from .ops.blind_rotate import mux_rotate_karatsuba
    from .ops.cmux_step import mux_rotate_baked
    from .ops.dots import from_kmajor
    from .tlwe import TLweSample

    l, b, t = bk.decomp_length, bk.log2_base, bk.block
    for s in range(bk.n):
        if bk.compact:
            acc = mux_rotate(TLweSample(acc, cv), bk.baked[s], bara_t[s], l,
                             b, bk.balanced).a
            continue
        e_s = from_kmajor(bk.baked[s]) if bk.layout == "kmajor" \
            else bk.baked[s]
        if bk.depth:
            acc = mux_rotate_karatsuba(acc, e_s, bara_t[s], l, b, t, bk.plan,
                                       bk.balanced)
        else:
            acc = mux_rotate_baked(acc, e_s, bara_t[s], l, b, t, bk.balanced)
    return acc


def crosscheck_blind_rotate(accum, bk, bara):
    """Debug-mode blind rotation: the dispatcher against the step-by-step
    loop, word for word. Returns the loop's result (safe mode). Called from
    `bootstrap.blind_rotate` when `TuningConfig.debug` is set."""
    from . import bootstrap, polynomial
    from .tlwe import TLweSample
    from .tuning import override

    with override(debug=False):
        fast = bootstrap.blind_rotate(accum, bk, bara)
    bara_t = bara.to(torch.int32).transpose(0, 1)
    ref_a = _loop_blind_rotate(accum.a, bk, bara_t, accum.cv)
    mismatch = int(torch.count_nonzero(fast.a != ref_a))
    if mismatch:
        raise FHEDebugError(
            f"debug crosscheck failed: {mismatch} int32 words differ between "
            "the rotation's dispatcher and the step-by-step loop at "
            "blind_rotate; suspect the CUDA kernels")
    # the gadget invariants on a live operand: the first CMUX step's
    # decomposition input (X^bara_0 - 1) * accum
    rot = polynomial.mul_by_monomial(accum.a, bara_t[0][:, None])
    check_gadget_invariants(rot - accum.a, bk.decomp_length, bk.log2_base,
                            bk.balanced)
    return TLweSample(ref_a, fast.cv)
