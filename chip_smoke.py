"""Smoke run of tfhe_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases, one line or a few each (any failure exits non-zero, nothing falls
back):

1. Device: the card's name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from csrc/ (one nvcc per source, in
   parallel; seconds; ptxas report).
3. Kernel against plain, `torch.equal`, on the card, with random
   accumulators, random keys and random bara including 0 and negatives:
   the baked Karatsuba rotation (128_fast with B = 256 and 300, toy,
   N = 1024 at depth 2, and the 80-bit shape with b = 10); the expansion
   kernel against `expand_karatsuba_step` and against that step of
   `bake_karatsuba` (128_fast, 128_fast8, N = 1024 l = 4 b = 6 depth 2);
   the compact rotation (128_fast8 with B = 256 and 300, 128_fast at depth
   1, N = 1024 at depth 2); the dense step's two kernels and its rotation
   (128_fast at depth 0 with B = 256 and 300, 128_fast8's M = 1, the
   80-bit shape with two digit limbs); the three multi-key kernels (one
   sparse step, a chunk of steps, a party's loop from its compact limbs)
   and the sparse expansion at N = 1024, depth 2 with the plans of 2 parties
   (both parties, l = 5 b = 6 and l = 4 b = 7), 4 parties and 8 parties
   (sparse-stored, party 5, triangular and full), B = 70. Then each kernel
   timed at B = 4096 over 8 steps beside its plain version, with its bound
   from the shapes.
4. Main path, baked: `make_key_pair(tfhe_parameters_128_fast)` on the card,
   `encrypt` of 4096 bits, 5 chained `gate_nand` layers, `decrypt`;
   requires 4096/4096 correct and one kernel launch per layer, and the
   kernel's rotation equal to the plain version's on 64 real ciphertexts.
5. Main path, compact: the same through `tfhe_parameters_128_fast8` under
   `tuning.override(bs_bake_budget=0)`: the key is compact with shape
   (630, 4, 18, 9, 256); 4096/4096 correct over 5 layers, one
   compact-rotation launch per layer; then one more layer under
   `torch.profiler` for the device time by kernel.
6. One raw 128_fast key in three forms (baked depth 1, compact, dense depth
   0): one NAND layer of 4096 through each, outputs bit-equal, each form's
   device bytes.
7. The default preset (`make_key_pair(gen)`: 80-bit, b = 10) on the card:
   one NAND layer of 256, all correct.
8. Multi-key main path: the ceremony of
   `mktfhe_parameters_2party_lownoise` on the card (n = 500, N = 1024,
   l = 5, b = 6), `mk_encrypt` of 4096 bits, 2 chained `mk_gate_nand`
   layers on the default (compact) path, `mk_decrypt`: 4096/4096 required,
   one compact-rotation launch per party and layer; one more layer under
   `torch.profiler`; then one layer each on the chunk and per-step paths,
   bit-equal to the compact one's.
9. `mktfhe_parameters_4party`, one NAND layer of 1024, and
   `mktfhe_parameters_8party` (sparse-stored key), one layer of 256, all
   correct.
10. The kernels' JSON line, the card's line, then the result line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SEED = 123
BATCH = 4096
LAYERS = 5  # the first NAND plus 4 chained ones, as bench.py runs them
TIMED_STEPS = 8
T = 128

# Published dense peaks of one H100 SXM (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_ALU_OPS_PER_S = 67e12  # outside the tensor cores


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the current stream, after a warm-up.
    The timed calls are enqueued behind a matmul of a few milliseconds, so
    that a short kernel's time is the device's and not the host's time to
    enqueue it: the start event fires when the matmul ends, by when the
    calls are queued."""
    fn()
    blocker = torch.empty((4096, 4096), device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.mm(blocker, blocker)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak rate. Returns (ms, which)."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def rand_i32(gen, shape):
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device)


def rand_i8(gen, shape):
    return torch.randint(-128, 128, shape, dtype=torch.int8, generator=gen,
                         device=gen.device)


def rand_bara(gen, n, n_steps, batch):
    bara_t = torch.randint(-n, n, (n_steps, batch), dtype=torch.int32,
                           generator=gen, device=gen.device)
    bara_t[:, 0] = 0
    bara_t[0, 1:] = 0
    return bara_t


def random_case(gen, k1, n, l, b, depth, n_steps, batch, form="baked"):
    """Random accumulator, key and bara for one kernel shape. form: "baked"
    (Karatsuba rows), "compact" (prepared limbs) or "dense" (2M blocks)."""
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    plan = karatsuba_plan(n // T, depth, b)
    pt = k1 * l * T
    if form == "compact":
        key = rand_i8(gen, (n_steps, 4, k1 * l, k1, 2 * n))
    else:
        rows = plan.total_rows if form == "baked" else 2 * (n // T)
        key = rand_i8(gen, (n_steps, rows * pt, k1 * 4 * T))
    kw = dict(l=l, b=b, t=T, balanced=(b == 8))
    if form != "dense":
        kw["plan"] = plan
    return (rand_i32(gen, (batch, k1, n)), key, rand_bara(gen, n, n_steps,
                                                          batch), kw)


class Kernels:
    """The comparison and timing results of phase 3, one entry per kernel."""

    def __init__(self):
        self.entries = {}

    def entry(self, name, source, replaces):
        return self.entries.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"tfhe_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None})

    def compare(self, name, what, got, want):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ent = self.entries[name]
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        check(torch.equal(got, want),
              f"{name} kernel != plain at {what} (max |diff| {err})")
        print(f"[3 kernel=plain] {name} {what}: equal", flush=True)

    def timed(self, name, what, kernel_fn, plain_fn, bound, card):
        ent = self.entries[name]
        ent["ms"] = cuda_ms(kernel_fn)
        ent["plain_ms"] = cuda_ms(plain_fn)
        ent["bound_ms"], ent["bound_by"] = bound
        print(f"[3 timing] {name} {what}: kernel {ent['ms']:.3f} ms, plain "
              f"{ent['plain_ms']:.3f} ms, bound {ent['bound_ms']:.4f} ms by "
              f"{ent['bound_by']}, no single library call | {card}",
              flush=True)


def phase3(gen, card) -> Kernels:
    from tfhe_tpu_torch.ops import cmux_step, compact
    from tfhe_tpu_torch.ops.blind_rotate import (
        blind_rotate_kernel,
        blind_rotate_plain,
    )
    from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba

    ks = Kernels()
    src = "tfhe_tpu/ops/pallas_cmux.py"
    ks.entry("blind_rotate", "blind_rotate.cu", f"{src}:645")[
        "also_replaces"] = f"{src}:1420"
    ks.entry("blind_rotate_compact", "compact.cu", f"{src}:1790")
    ks.entry("expand_karatsuba_step", "compact.cu", f"{src}:1737")
    ks.entry("rotate_decompose", "cmux_step.cu", f"{src}:39")
    ks.entry("cmux_matmul", "cmux_step.cu", f"{src}:92")

    def shape(k1, n, l, b, depth, n_steps, batch):
        return (f"K={k1} N={n} l={l} b={b} depth={depth} steps={n_steps} "
                f"B={batch}")

    # the baked Karatsuba rotation (rows 1-2), with the b = 10 shape
    for name, *dims in [("128_fast", 5, 256, 2, 8, 1, 8, 256),
                        ("128_fast", 5, 256, 2, 8, 1, 8, 300),
                        ("toy", 2, 256, 3, 7, 1, 8, 64),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 64),
                        ("80bit_b10", 2, 1024, 2, 10, 2, 4, 64)]:
        acc, key, bara_t, kw = random_case(gen, *dims)
        ks.compare("blind_rotate", f"{name} {shape(*dims)}",
                   blind_rotate_kernel(acc, key, bara_t, **kw),
                   blind_rotate_plain(acc, key, bara_t, **kw))

    # the expansion kernel (row 6), against the plain version and the bake
    for name, *dims in [("128_fast", 5, 256, 2, 8, 1),
                        ("128_fast8", 9, 128, 2, 8, 0),
                        ("N1024_l4_b6_depth2", 2, 1024, 4, 6, 2)]:
        _, limbs, _, kw = random_case(gen, *dims, 2, 1, form="compact")
        kw = dict(t=T, plan=kw["plan"])
        got = compact.expand_step_kernel(limbs[1], **kw)
        what = "{} K={} N={} l={} b={} depth={}".format(name, *dims)
        ks.compare("expand_karatsuba_step", what, got,
                   compact.expand_step_plain(limbs[1], **kw))
        ks.compare("expand_karatsuba_step", what + " (bake_karatsuba)", got,
                   bake_karatsuba(limbs, T, kw["plan"])[1])

    # the compact rotation (row 6)
    for name, *dims in [("128_fast8", 9, 128, 2, 8, 0, 6, 256),
                        ("128_fast8", 9, 128, 2, 8, 0, 6, 300),
                        ("128_fast", 5, 256, 2, 8, 1, 6, 300),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 64)]:
        acc, limbs, bara_t, kw = random_case(gen, *dims, form="compact")
        ks.compare(
            "blind_rotate_compact", f"{name} {shape(*dims)}",
            compact.blind_rotate_compact_kernel(acc, limbs, bara_t, **kw),
            compact.blind_rotate_compact_plain(acc, limbs, bara_t, **kw))

    # the dense step's two kernels and its rotation (rows 4 and 5)
    for name, *dims in [("128_fast", 5, 256, 2, 8, 0, 6, 256),
                        ("128_fast", 5, 256, 2, 8, 0, 6, 300),
                        ("128_fast8_M1", 9, 128, 2, 8, 0, 6, 300),
                        ("80bit_two_limbs", 2, 1024, 2, 10, 0, 4, 64)]:
        acc, key, bara_t, kw = random_case(gen, *dims, form="dense")
        what = f"{name} {shape(*dims)}"
        digits = cmux_step.rotate_decompose_kernel(bara_t[1], acc, **kw)
        ks.compare("rotate_decompose", what, digits.contiguous(),
                   cmux_step.rotate_decompose_plain(bara_t[1], acc, **kw))
        mm = dict(l=kw["l"], b=kw["b"], t=T)
        ks.compare("cmux_matmul", what,
                   cmux_step.cmux_matmul_kernel(digits, acc, key[1], **mm),
                   cmux_step.cmux_matmul_plain(digits, acc, key[1], **mm))
        ks.compare(
            "cmux_matmul", what + " (whole rotation)",
            cmux_step.blind_rotate_dense_kernel(acc, key, bara_t, **kw),
            cmux_step.blind_rotate_dense_plain(acc, key, bara_t, **kw))

    # timings at B = 4096 over TIMED_STEPS steps, with the bound of the work
    steps = TIMED_STEPS
    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 1, steps, BATCH)
    io = nbytes(acc, acc, key, bara_t)  # acc read once, written once
    dots = 2.0 * kw["plan"].macs_superblocks * BATCH * key.shape[2] \
        * (5 * 2 * T) * steps
    ks.timed("blind_rotate", f"128_fast B={BATCH}, {steps} steps",
             lambda: blind_rotate_kernel(acc, key, bara_t, **kw),
             lambda: blind_rotate_plain(acc, key, bara_t, **kw),
             bound_ms(io, dots, PEAK_INT8_OPS_PER_S), card)

    acc, limbs, bara_t, kw = random_case(gen, 9, 128, 2, 8, 0, steps, BATCH,
                                         form="compact")
    pt, cols = 9 * 2 * T, 9 * 4 * T
    io = nbytes(acc, acc, limbs, bara_t)
    dots = 2.0 * kw["plan"].macs_superblocks * BATCH * pt * cols * steps
    ks.timed("blind_rotate_compact", f"128_fast8 B={BATCH}, {steps} steps",
             lambda: compact.blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                         **kw),
             lambda: compact.blind_rotate_compact_plain(acc, limbs, bara_t,
                                                        **kw),
             bound_ms(io, dots, PEAK_INT8_OPS_PER_S), card)

    ekw = dict(t=T, plan=kw["plan"])
    out_bytes = kw["plan"].total_rows * pt * cols
    # per output byte about 3 integer operations (select, split, store)
    ks.timed("expand_karatsuba_step", "128_fast8, one step",
             lambda: compact.expand_step_kernel(limbs[0], **ekw),
             lambda: compact.expand_step_plain(limbs[0], **ekw),
             bound_ms(nbytes(limbs[0]) + out_bytes, 3.0 * out_bytes,
                      PEAK_ALU_OPS_PER_S), card)

    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 0, steps, BATCH,
                                       form="dense")
    mm = dict(l=2, b=8, t=T)
    digits = cmux_step.rotate_decompose_kernel(bara_t[1], acc, **kw)
    # per accumulator word about 12 integer operations (rotate, cut l digits)
    ks.timed(
        "rotate_decompose", f"128_fast depth 0 B={BATCH}, {steps} launches",
        lambda: [cmux_step.rotate_decompose_kernel(bara_t[s], acc, **kw)
                 for s in range(steps)],
        lambda: [cmux_step.rotate_decompose_plain(bara_t[s], acc, **kw)
                 for s in range(steps)],
        bound_ms(steps * nbytes(acc, digits, bara_t[0]),
                 steps * 12.0 * acc.numel(), PEAK_ALU_OPS_PER_S), card)
    dots = 2.0 * digits.shape[0] * BATCH * digits.shape[2] * key.shape[2] \
        * (256 // T)
    ks.timed(
        "cmux_matmul", f"128_fast depth 0 B={BATCH}, {steps} launches",
        lambda: [cmux_step.cmux_matmul_kernel(digits, acc, key[s], **mm)
                 for s in range(steps)],
        lambda: [cmux_step.cmux_matmul_plain(digits, acc, key[s], **mm)
                 for s in range(steps)],
        bound_ms(steps * nbytes(digits, acc, acc, key[0]), steps * dots,
                 PEAK_INT8_OPS_PER_S), card)
    phase3_mk(ks, gen, card)
    return ks


MK_SRC = "tfhe_tpu/ops/pallas_cmux.py"
MK_N = 1024  # every multi-key preset's ring degree: M = 8, depth 2


def mk_case(gen, parties, party, l, b, n_steps, batch, progressive=True,
            sparse=False):
    """Random accumulator, nz-selected compact limbs and bara for one
    party's plan; the limbs are cut from a dense prepared operand or from a
    sparse-stored one, as `mk_blind_rotate` cuts them."""
    from tfhe_tpu_torch.mk.internals import active_plan
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan, select_nz_limbs

    plan = karatsuba_plan(MK_N // T, 2, b)
    nz_orig, nz_kern, sel, k_act = active_plan(party, parties, progressive)
    k1 = parties + 1
    if sparse:
        limbs = rand_i8(gen, (n_steps, 4, 3 * parties + 1, l, 2 * MK_N))
        if sel is not None:
            limbs = limbs[:, :, list(sel)].contiguous()
    else:
        dense = rand_i8(gen, (n_steps, 4, k1 * l, k1, 2 * MK_N))
        limbs = select_nz_limbs(dense, nz_orig, l)
    kw = dict(l=l, b=b, t=T, plan=plan, nz=nz_kern, balanced=False)
    return (rand_i32(gen, (batch, k_act, MK_N)), limbs,
            rand_bara(gen, MK_N, n_steps, batch), kw)


def phase3_mk(ks, gen, card):
    """The three multi-key kernels and the sparse expansion against their
    plain versions, then their times at the 2-party lownoise shape."""
    from tfhe_tpu_torch.ops import mk_cmux
    from tfhe_tpu_torch.ops.karatsuba import expand_karatsuba_sparse

    ks.entry("cmux_step_sparse", "mk_cmux.cu", f"{MK_SRC}:950")
    ks.entry("mk_blind_rotate_chunk", "mk_cmux.cu", f"{MK_SRC}:1006")
    ks.entry("mk_blind_rotate_compact", "mk_cmux.cu", f"{MK_SRC}:1150")

    def expand_all(limbs, kw, fn):
        ekw = dict(t=T, plan=kw["plan"], nz=kw["nz"], l=kw["l"])
        return torch.stack([fn(step, **ekw) for step in limbs])

    cases = [  # parties, party, l, b, steps, batch, progressive, sparse
        (2, 0, 5, 6, 3, 70, True, False),
        (2, 1, 5, 6, 3, 70, True, False),
        (2, 0, 4, 7, 3, 70, True, False),
        (2, 1, 4, 7, 3, 70, True, False),
        (4, 2, 5, 6, 3, 70, True, False),
        (4, 3, 5, 6, 2, 70, False, False),
        (8, 5, 8, 4, 2, 70, True, True),
        (8, 5, 8, 4, 2, 70, False, True),  # K = 9, P = 72: 73,728 digit bytes
    ]
    for parties, party, l, b, n_steps, batch, progressive, sparse in cases:
        acc, limbs, bara_t, kw = mk_case(gen, parties, party, l, b, n_steps,
                                         batch, progressive, sparse)
        what = (f"{parties} parties, party {party}, l={l} b={b} "
                f"K={acc.shape[1]} NZ={len(kw['nz'])} steps={n_steps} "
                f"B={batch}" + (" sparse-stored" if sparse else "")
                + ("" if progressive else " full plan"))
        e_chunk = expand_all(
            limbs, kw, lambda st, **ekw: mk_cmux.expand_sparse(
                st, preselected=True, **ekw))
        ks.compare("expand_karatsuba_step", what + " (sparse expansion)",
                   e_chunk, expand_all(
                       limbs, kw, lambda st, t, plan, nz, l:
                       expand_karatsuba_sparse(st, t, plan, nz, l, True)))
        ks.compare("cmux_step_sparse", what,
                   mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[1], bara_t[1],
                                                   **kw),
                   mk_cmux.cmux_step_sparse_plain(acc, e_chunk[1], bara_t[1],
                                                  **kw))
        ks.compare("mk_blind_rotate_chunk", what,
                   mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t,
                                                        **kw),
                   mk_cmux.mk_blind_rotate_chunk_plain(acc, e_chunk, bara_t,
                                                       **kw))
        ks.compare("mk_blind_rotate_compact", what,
                   mk_cmux.mk_blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                          **kw),
                   mk_cmux.mk_blind_rotate_compact_plain(acc, limbs, bara_t,
                                                         **kw))
        del e_chunk

    # timings: party 1's plan of 2-party lownoise (K = 3, NZ = 7), B = 4096
    steps = TIMED_STEPS
    acc, limbs, bara_t, kw = mk_case(gen, 2, 1, 5, 6, steps, BATCH)
    e_chunk = expand_all(limbs, kw, lambda st, **ekw: mk_cmux.expand_sparse(
        st, preselected=True, **ekw))
    nzn, lt = len(kw["nz"]), kw["l"] * T
    # each of the plan's digit x key tile products once: [B, l*T] x [l*T, 4T]
    dots = 2.0 * kw["plan"].macs_superblocks * nzn * BATCH * lt * 4 * T * steps
    what = f"2-party lownoise party 1 (K=3, NZ=7) B={BATCH}, {steps} steps"
    ks.timed(
        "cmux_step_sparse", what + " (one call each)",
        lambda: [mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[s], bara_t[s],
                                                 **kw) for s in range(steps)],
        lambda: [mk_cmux.cmux_step_sparse_plain(acc, e_chunk[s], bara_t[s],
                                                **kw) for s in range(steps)],
        bound_ms(steps * nbytes(acc, acc, e_chunk[0], bara_t[0]), dots,
                 PEAK_INT8_OPS_PER_S), card)
    ks.timed(
        "mk_blind_rotate_chunk", what,
        lambda: mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t,
                                                     **kw),
        lambda: mk_cmux.mk_blind_rotate_chunk_plain(acc, e_chunk, bara_t,
                                                    **kw),
        bound_ms(nbytes(acc, acc, e_chunk, bara_t), dots,
                 PEAK_INT8_OPS_PER_S), card)
    ks.timed(
        "mk_blind_rotate_compact", what,
        lambda: mk_cmux.mk_blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                       **kw),
        lambda: mk_cmux.mk_blind_rotate_compact_plain(acc, limbs, bara_t,
                                                      **kw),
        bound_ms(nbytes(acc, acc, limbs, bara_t), dots, PEAK_INT8_OPS_PER_S),
        card)


def nand_chain(tp, ck, sk, gen, layers, batch, dev):
    """Encrypt, `layers` chained NANDs, decrypt. Returns (output sample,
    number correct, seconds of the chain)."""
    idx = torch.arange(batch, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    ct_x = tp.encrypt(gen, sk, bits_x)
    ct_y = tp.encrypt(gen, sk, bits_y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tp.gate_nand(ck, ct_x, ct_y)
    for _ in range(layers - 1):
        out = tp.gate_nand(ck, out, ct_y)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    want = ~(bits_x & bits_y)
    for _ in range(layers - 1):
        want = ~(want & bits_y)
    correct = int((tp.decrypt(sk, out) == want).sum())
    check(out.a.shape == (batch, sk.params.lwe_size)
          and out.b.shape == (batch,), "output shape")
    check(bool(torch.isfinite(out.cv).all()), "non-finite noise variance")
    check(correct == batch, f"{correct}/{batch} decrypt correctly")
    return (ct_x, ct_y), out, correct, chain_s


def reset_counts():
    from tfhe_tpu_torch.ops import cmux_step, compact, mk_cmux
    from tfhe_tpu_torch.ops.blind_rotate import blind_rotate_kernel

    wrappers = {
        "blind_rotate": blind_rotate_kernel,
        "blind_rotate_compact": compact.blind_rotate_compact_kernel,
        "expand_karatsuba_step": compact.expand_step_kernel,
        "rotate_decompose": cmux_step.rotate_decompose_kernel,
        "cmux_matmul": cmux_step.cmux_matmul_kernel,
        "cmux_step_sparse": mk_cmux.cmux_step_sparse_kernel,
        "mk_blind_rotate_chunk": mk_cmux.mk_blind_rotate_chunk_kernel,
        "mk_blind_rotate_compact": mk_cmux.mk_blind_rotate_compact_kernel,
    }
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_counts(wrappers) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def profile_layer(tag, what, fn, wall_ms, card):
    """One call of `fn` under torch.profiler: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    check(total > 0, "torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    print(f"[{tag} profile] {what}: device {total:.1f} ms under "
          f"torch.profiler, against {wall_ms:.1f} ms of wall time per layer "
          f"of the unprofiled chain: idle share "
          f"{100 * (1 - total / wall_ms):.1f}% | {card}", flush=True)
    for name, ms, count in rows[:6]:
        print(f"[{tag} profile]   {ms:9.3f} ms {100 * ms / total:5.1f}% "
              f"x{count:<5d} {name[:90]}", flush=True)
    rest = sum(ms for _, ms, _ in rows[6:])
    print(f"[{tag} profile]   {rest:9.3f} ms {100 * rest / total:5.1f}% "
          f"everything else ({max(len(rows) - 6, 0)} kernels)", flush=True)
    return out


def phase4_baked(tp, ks, dev, card):
    from tfhe_tpu_torch.lwe import lwe_noiseless_trivial
    from tfhe_tpu_torch.numeric import decode_message, encode_message
    from tfhe_tpu_torch.ops.blind_rotate import (
        blind_rotate_kernel,
        blind_rotate_plain,
    )
    from tfhe_tpu_torch.polynomial import mul_by_monomial
    from tfhe_tpu_torch.tlwe import tlwe_noiseless_trivial

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tp.tfhe_parameters_128_fast()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    sk, ck = tp.make_key_pair(gen, params)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk = ck.bootstrap_key
    check(tuple(bk.baked.shape) == (630, 3840, 2560) and bk.depth == 1
          and not bk.compact,
          f"unexpected baked key {tuple(bk.baked.shape)} depth {bk.depth}")

    wrappers = reset_counts()
    (ct_x, ct_y), _, correct, chain_s = nand_chain(tp, ck, sk, gen, LAYERS,
                                                   BATCH, dev)
    counts = read_counts(wrappers)
    launches = counts["blind_rotate"]
    check(launches == LAYERS,
          f"{launches} kernel launches in {LAYERS} NAND layers")
    check(sum(counts.values()) == launches,
          f"the baked path launched other kernels: {counts}")
    ks.entries["blind_rotate"]["launches"] = launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # The kernel's rotation on real ciphertexts against the plain version:
    # the accumulator of the first NAND layer's first 64 gates.
    small = 64
    mu = encode_message(1, 8)
    first = [tp.LweSample(*(f[:small] for f in ct)) for ct in (ct_x, ct_y)]
    x = lwe_noiseless_trivial(mu, params.lwe_size, (small,), dev) \
        - first[0] - first[1]
    bara_t = decode_message(x.a, 2 * params.N).t().contiguous()
    barb = decode_message(x.b, 2 * params.N)
    testv = torch.full((small, params.N), mu, dtype=torch.int32, device=dev)
    acc0 = tlwe_noiseless_trivial(mul_by_monomial(testv, -barb),
                                  params.k).a.contiguous()
    kw = dict(l=bk.decomp_length, b=bk.log2_base, t=bk.block, plan=bk.plan,
              balanced=bk.balanced)
    got_rot = blind_rotate_kernel(acc0, bk.baked, bara_t, **kw)
    want_rot = blind_rotate_plain(acc0, bk.baked, bara_t, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got_rot, want_rot),
          "kernel != plain on the real 128_fast key")
    print(f"[4 main path] 128_fast keygen {keygen_s:.2f} s | {LAYERS} NAND "
          f"layers x {BATCH} in {chain_s:.3f} s = "
          f"{BATCH * LAYERS / chain_s:.1f} gates/s | "
          f"{correct}/{BATCH} correct | kernel launches {launches} "
          f"(expected {LAYERS}) | peak {peak_gb:.2f} GB | real-key rotation "
          f"kernel=plain on {small} | {card}", flush=True)


def phase5_compact(tp, ks, dev, card):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tp.tfhe_parameters_128_fast8()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    with tp.tuning.override(bs_bake_budget=0):
        sk, ck = tp.make_key_pair(gen, params)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk = ck.bootstrap_key
    check(bk.compact and tuple(bk.baked.shape) == (630, 4, 18, 9, 256)
          and bk.depth == 0 and bk.block == T,
          f"unexpected compact key {tuple(bk.baked.shape)} depth {bk.depth}")

    wrappers = reset_counts()
    (ct_x, ct_y), _, correct, chain_s = nand_chain(tp, ck, sk, gen, LAYERS,
                                                   BATCH, dev)
    counts = read_counts(wrappers)
    launches = counts["blind_rotate_compact"]
    check(launches == LAYERS and counts["expand_karatsuba_step"] == LAYERS,
          f"compact launches {counts} in {LAYERS} NAND layers")
    check(sum(counts.values()) == 2 * LAYERS,
          f"the compact path launched other kernels: {counts}")
    ks.entries["blind_rotate_compact"]["launches"] = launches
    ks.entries["expand_karatsuba_step"]["launches"] = \
        counts["expand_karatsuba_step"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    key_mb = bk.baked.numel() / 1e6
    print(f"[5 main path] 128_fast8 compact keygen {keygen_s:.2f} s | key "
          f"{key_mb:.1f} MB | {LAYERS} NAND layers x {BATCH} in "
          f"{chain_s:.3f} s = {BATCH * LAYERS / chain_s:.1f} gates/s | "
          f"{correct}/{BATCH} correct | compact-rotation launches {launches} "
          f"(expected {LAYERS}) | peak {peak_gb:.2f} GB | {card}", flush=True)

    profile_layer("5", f"one 128_fast8 layer of {BATCH}",
                  lambda: tp.gate_nand(ck, ct_x, ct_y),
                  chain_s / LAYERS * 1e3, card)


def phase6_three_forms(tp, ks, dev, card):
    from tfhe_tpu_torch.bootstrap import bootstrap_key_from_raw
    from tfhe_tpu_torch.keyswitch import keyswitch_key_gen
    from tfhe_tpu_torch.tgsw import tgsw_encrypt
    from tfhe_tpu_torch.tlwe import extract_lwe_key, tlwe_key_gen

    params = tp.tfhe_parameters_128_fast()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    sk = tp.make_secret_key(gen, params)
    tlwe_key = tlwe_key_gen(gen, params.N, params.k)
    l, b = params.bs_decomp_length, params.bs_log2_base
    gsw = tgsw_encrypt(gen, sk.key, params.bs_noise_stddev, tlwe_key, l, b,
                       batch_shape=(params.lwe_size,))
    ksk = keyswitch_key_gen(gen, params.ks_noise_stddev,
                            extract_lwe_key(tlwe_key), sk.key,
                            params.ks_decomp_length, params.ks_log2_base)
    idx = torch.arange(BATCH, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    ct_x, ct_y = tp.encrypt(gen, sk, bits_x), tp.encrypt(gen, sk, bits_y)

    forms = [  # (name, tuning, kernels that must launch once per step/layer)
        ("baked depth 1", dict(karatsuba_depth=1),
         {"blind_rotate": 1}),
        ("compact", dict(karatsuba_depth=1, bs_bake_budget=0),
         {"blind_rotate_compact": 1, "expand_karatsuba_step": 1}),
        ("dense depth 0", dict(karatsuba_depth=0),
         {"rotate_decompose": params.lwe_size,
          "cmux_matmul": params.lwe_size}),
    ]
    outs = []
    for name, knobs, expected in forms:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with tp.tuning.override(**knobs):
            bk = bootstrap_key_from_raw(
                gsw, l, b, noise_stddev=params.bs_noise_stddev,
                balanced=params.gadget_balanced)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ck = tp.CloudKey(params, bk, ksk)
        wrappers = reset_counts()
        t0 = time.perf_counter()
        out = tp.gate_nand(ck, ct_x, ct_y)
        torch.cuda.synchronize()
        layer_s = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        check(counts == expected, f"{name}: launches {counts}, "
              f"expected {expected}")
        correct = int((tp.decrypt(sk, out) == ~(bits_x & bits_y)).sum())
        check(correct == BATCH, f"{name}: {correct}/{BATCH} correct")
        if name.startswith("dense"):
            for kernel in expected:
                ks.entries[kernel]["launches"] = counts[kernel]
        print(f"[6 three forms] {name}: key {tuple(bk.baked.shape)} = "
              f"{bk.baked.numel() / 1e6:.1f} MB, built in {build_s:.2f} s | "
              f"one NAND layer x {BATCH} in {layer_s:.3f} s | "
              f"{correct}/{BATCH} correct | launches {counts} | peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
              flush=True)
        outs.append((out.a.clone(), out.b.clone()))
        del bk, ck, out
    for (a, b_), (name, _, _) in zip(outs[1:], forms[1:]):
        check(torch.equal(a, outs[0][0]) and torch.equal(b_, outs[0][1]),
              f"{name} output differs from the baked form's")
    print("[6 three forms] a and b of the three outputs: bit-equal",
          flush=True)


def phase7_default_preset(tp, dev, card):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    sk, ck = tp.make_key_pair(gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk = ck.bootstrap_key
    check(bk.log2_base == 10 and bk.depth == 2, "not the 80-bit preset")
    wrappers = reset_counts()
    batch = 256
    _, _, correct, chain_s = nand_chain(tp, ck, sk, gen, 1, batch, dev)
    check(read_counts(wrappers)["blind_rotate"] == 1, "no kernel launch")
    print(f"[7 default preset] 80-bit (b=10, N=1024, depth 2) keygen "
          f"{keygen_s:.2f} s | one NAND layer x {batch} in {chain_s:.3f} s | "
          f"{correct}/{batch} correct | {card}", flush=True)


def mk_ceremony(tp, mk, params, parties, gen, dev):
    """Shared key, secret keys, every party's part, the server's assembly.
    Returns (secret keys, cloud key, seconds, key bytes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shared = mk.make_shared_key(gen, params)
    sks = [tp.make_secret_key(gen, params) for _ in range(parties)]
    parts = [mk.make_cloud_key_part(gen, sk, shared) for sk in sks]
    ck = mk.make_mk_cloud_key(parts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    bk = ck.bootstrap_key
    key_bytes = nbytes(*(bk.limbs if bk.sparse else [bk.limbs]),
                       *(k.table_limbs for k in ck.keyswitch_keys))
    return sks, ck, seconds, key_bytes


def mk_nand_chain(mk, ck, sks, gen, layers, batch, dev):
    """mk_encrypt, `layers` chained mk_gate_nand, mk_decrypt. Returns the
    inputs, the first layer's output, the number correct and the chain's
    seconds."""
    idx = torch.arange(batch, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    ct_x = mk.mk_encrypt(gen, sks, bits_x)
    ct_y = mk.mk_encrypt(gen, sks, bits_y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = out = mk.mk_gate_nand(ck, ct_x, ct_y)
    for _ in range(layers - 1):
        out = mk.mk_gate_nand(ck, out, ct_y)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    want = ~(bits_x & bits_y)
    for _ in range(layers - 1):
        want = ~(want & bits_y)
    correct = int((mk.mk_decrypt(sks, out) == want).sum())
    check(out.a.shape == (batch, len(sks), sks[0].params.lwe_size)
          and out.b.shape == (batch,), "MK output shape")
    check(bool(torch.isfinite(out.cv).all()), "non-finite noise variance")
    check(correct == batch, f"{correct}/{batch} MK gates decrypt correctly")
    return (ct_x, ct_y), first, correct, chain_s


MK_LAYERS = 2


def phase8_mk_two_party(tp, ks, dev, card):
    from tfhe_tpu_torch import mk
    from tfhe_tpu_torch.mk.internals import active_plan
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = mk.mktfhe_parameters_2party_lownoise()
    parties, n_lwe = 2, params.lwe_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sks, ck, ceremony_s, key_bytes = mk_ceremony(tp, mk, params, parties,
                                                 gen, dev)
    bk = ck.bootstrap_key
    check(not bk.sparse and bk.block == 0
          and tuple(bk.limbs.shape) == (1000, 4, 15, 3, 2048),
          f"unexpected MK key: block {bk.block}, sparse {bk.sparse}")

    wrappers = reset_counts()
    (ct_x, ct_y), _, correct, chain_s = mk_nand_chain(
        mk, ck, sks, gen, MK_LAYERS, BATCH, dev)
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    expected = {"mk_blind_rotate_compact": MK_LAYERS * parties,
                "expand_karatsuba_step": MK_LAYERS * parties}
    check(counts == expected,
          f"MK compact path launches {counts}, expected {expected}")
    ks.entries["mk_blind_rotate_compact"]["launches"] = \
        counts["mk_blind_rotate_compact"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = MK_LAYERS * parties * n_lwe
    # the least a step could take: the plan's tile products once each, the
    # mean over the two parties' plans (K = 2, NZ = 4 and K = 3, NZ = 7)
    plan = karatsuba_plan(params.N // T, 2, bk.log2_base)
    plans = [active_plan(p, parties, True) for p in range(parties)]
    nz_mean = sum(len(pl[1]) for pl in plans) / parties
    k_mean = sum(pl[3] for pl in plans) / parties
    l, n = bk.decomp_length, params.N
    step_ops = 2.0 * plan.macs_superblocks * nz_mean * BATCH * l * T * 4 * T
    # acc read and written, the step's compact limbs, its bara
    step_bytes = 2 * BATCH * k_mean * n * 4 + 4 * nz_mean * l * 2 * n \
        + BATCH * 4
    step_bound, by = bound_ms(step_bytes, step_ops, PEAK_INT8_OPS_PER_S)
    print(f"[8 MK main path] 2party_lownoise ceremony {ceremony_s:.2f} s | "
          f"key {key_bytes / 1e6:.1f} MB (bootstrap "
          f"{tuple(bk.limbs.shape)} + {parties} keyswitch tables) | "
          f"{MK_LAYERS} NAND layers x {BATCH} in {chain_s:.3f} s = "
          f"{BATCH * MK_LAYERS / chain_s:.1f} gates/s, "
          f"{chain_s / steps * 1e3:.3f} ms per CMUX step over {steps} steps "
          f"beside a bound of {step_bound:.4f} ms by {by} | "
          f"{correct}/{BATCH} correct | launches {counts} | peak "
          f"{peak_gb:.2f} GB | {card}", flush=True)

    first = profile_layer(
        "8", f"one 2party_lownoise layer of {BATCH}, compact path",
        lambda: mk.mk_gate_nand(ck, ct_x, ct_y),
        chain_s / MK_LAYERS * 1e3, card)

    others = [  # (name, knobs, kernel, its launches per layer)
        ("chunk", dict(mk_compact="0", mk_mega="1"),
         "mk_blind_rotate_chunk", parties * n_lwe // 20),
        ("per-step", dict(mk_compact="0", mk_mega="0"),
         "cmux_step_sparse", parties * n_lwe),
    ]
    for name, knobs, kernel, n_launch in others:
        wrappers = reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tp.tuning.override(**knobs):
            out = mk.mk_gate_nand(ck, ct_x, ct_y)
        torch.cuda.synchronize()
        layer_s = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        expected = {kernel: n_launch,
                    "expand_karatsuba_step": parties * n_lwe}
        check(counts == expected,
              f"MK {name} path launches {counts}, expected {expected}")
        ks.entries[kernel]["launches"] = counts[kernel]
        check(torch.equal(out.a, first.a) and torch.equal(out.b, first.b),
              f"MK {name} path output differs from the compact path's")
        print(f"[8 MK paths] {name}: one NAND layer x {BATCH} in "
              f"{layer_s:.3f} s, {layer_s / (parties * n_lwe) * 1e3:.3f} ms "
              f"per step | launches {counts} | a and b bit-equal to the "
              f"compact path's | {card}", flush=True)


def phase9_mk_more_parties(tp, dev, card):
    from tfhe_tpu_torch import mk

    for parties, make_params, batch, sparse in [
            (4, mk.mktfhe_parameters_4party, 1024, False),
            (8, mk.mktfhe_parameters_8party, 256, True)]:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = make_params()
        gen = torch.Generator(device=dev).manual_seed(SEED + parties)
        sks, ck, ceremony_s, key_bytes = mk_ceremony(tp, mk, params, parties,
                                                     gen, dev)
        bk = ck.bootstrap_key
        check(bk.sparse == sparse and bk.block == 0,
              f"{parties}-party key: sparse {bk.sparse}, block {bk.block}")
        wrappers = reset_counts()
        _, _, correct, layer_s = mk_nand_chain(mk, ck, sks, gen, 1, batch,
                                               dev)
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        check(counts.get("mk_blind_rotate_compact") == parties,
              f"{parties}-party launches {counts}")
        print(f"[9 MK {parties} parties] ceremony {ceremony_s:.2f} s | key "
              f"{key_bytes / 1e6:.1f} MB"
              f"{' (sparse-stored)' if sparse else ''} | one NAND layer x "
              f"{batch} in {layer_s:.3f} s = {batch / layer_s:.1f} gates/s, "
              f"{layer_s / (parties * params.lwe_size) * 1e3:.3f} ms per "
              f"step | {correct}/{batch} correct | launches {counts} | peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
              flush=True)
        del ck, bk


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import tfhe_tpu_torch as tp
    from tfhe_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text().splitlines()
    report = []
    for kernel in ("rotate_decompose_kernelIa", "rotate_decompose_kernelIs",
                   "leaf_dots_kernel", "mk_unit_dots_kernel", "expand_kernel",
                   "rotate_decompose_dense_kernel"):
        at = next((i for i, ln in enumerate(log)
                   if "Compiling entry function" in ln and kernel in ln), None)
        used = next((x for x in log[at:] if "Used" in x), None) \
            if at is not None else None
        check(used is not None, f"no ptxas report for {kernel}")
        report.append(f"{kernel}: {used.split(':', 1)[1].strip()}")
    spills = [ln for ln in log if "spill" in ln and "0 bytes spill stores, "
              "0 bytes spill loads" not in ln]
    print(f"[2 build] {build_s:.2f} s, {len(_build._SOURCES)} sources in "
          f"parallel | " + " | ".join(report)
          + f" | kernels with spills: {len(spills)}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ks = phase3(gen, card)
    torch.cuda.empty_cache()
    phase4_baked(tp, ks, dev, card)
    phase5_compact(tp, ks, dev, card)
    phase6_three_forms(tp, ks, dev, card)
    phase7_default_preset(tp, dev, card)
    phase8_mk_two_party(tp, ks, dev, card)
    phase9_mk_more_parties(tp, dev, card)

    for ent in ks.entries.values():
        check(ent["launches"] > 0,
              f"{ent['name']} was never launched on a driven path")
        check(None not in (ent["ms"], ent["plain_ms"], ent["bound_ms"]),
              f"{ent['name']} was not timed")
    print(json.dumps({"kernels": list(ks.entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
