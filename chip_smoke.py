"""Smoke run of tfhe_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases, one line or a few each (any failure exits non-zero, nothing falls
back):

1. Device: the card's name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from csrc/ (one nvcc per source, in
   parallel; seconds; ptxas report).
3. Kernel against plain, `torch.equal`, on the card, with random
   accumulators, random keys and random bara including 0 and negatives:
   the first launch of every rotation step alone (`digit_rows_kernel`
   against `digit_rows_plain`: 128_fast with B = 256 and 300, 128_fast8,
   N = 1024 at depth 2, 128_pbs, 128_radix_reliable, the 80-bit b = 10
   shape (the bytes it defines), the 2-party MK plans with K = 2 and 3, and
   8 parties with K = 9; B = 70 unless named), then its time at the
   presets' shapes (B = 4096, 256 for 8 parties) beside its byte bound;
   the baked Karatsuba rotation (128_fast with B = 256 and 300, toy,
   N = 1024 at depth 2 (`tfhe_parameters_128`'s plan) with B = 64, 70,
   130 and 200 and at B = 4096 over 2 steps, the plans of 128_pbs (K = 3, N = 512) and
   128_radix_reliable (l = 4, b = 6) with B = 70, and the 80-bit shape with
   b = 10); the expansion
   kernel in both layouts against `expand_karatsuba_step` and against that
   step of `bake_karatsuba` (128_fast, 128_fast8, N = 1024 l = 4 b = 6
   depth 2);
   the compact rotation (128_fast8 with B = 256 and 300, 128_fast at depth
   1, N = 1024 at depth 2 with B = 64 and 70, the plan of
   128_radix_reliable with B = 70); the
   dense step's two kernels and its rotation
   (128_fast at depth 0 with B = 256 and 300, 128_fast8's M = 1, the
   80-bit shape with two digit limbs); the three multi-key kernels (one
   sparse step, a chunk of steps, a party's loop from its compact limbs)
   and the sparse expansion (K-major and the reference layout) at N = 1024,
   depth 2 with the plans of 2 parties (both parties, l = 5 b = 6 and
   l = 4 b = 7), 4 parties and 8 parties (sparse-stored, party 5,
   triangular and full), B = 70, and the 2-party plans (l = 5 b = 6) at
   B = 130 (both parties) and 200 (party 1); the fused Karatsuba step,
   handed the
   K-major step, against its plain version and against the whole-rotation
   kernel at one step and at eight, B = 70 (a ragged second batch tile),
   at the plans of 128_fast, 128_radix, 128_radix_reliable, 128_pbs and the
   80-bit preset. The
   whole-rotation and dense kernels read their key K-major
   (`ops/dots.py:to_kmajor`), the plain versions the reference layout of the
   same bytes; the multi-key operands are K-major on the card, relaid with
   `from_kmajor` for the plain versions. Each line of a case that runs the
   dots kernels names `r`, the batch rows of a block, as the call's
   `dots.row_tile.<r>` count shows it, and `c`, the blocks of their
   clusters, as its `dots.clustered` count shows it (one a C entry call
   whose launches run in clusters), and checks both against
   `ops/dots.py:row_tile` and `cluster_size`: r = 128 at N = 1024 past
   B = 64, else 64; c = 2 where the batch tiles pair up (B = 70 and 256 at
   64 rows, 130, 200 and 4096 at 128), else 1, a plain launch (B = 64,
   300, and 70 at 128 rows). Then each kernel timed at B = 4096
   over 8 steps beside its plain version, with its bound from the shapes;
   for the dots kernels also
   the int8 operations executed (from the product tables they read) and
   useful (from the plan), and a cuBLAS yardstick: the summed time of
   `torch._int_mm` over the step's distinct products at the same shapes
   (the products only, not the function; no path of the port calls it);
   the expansion K-major, the layout the compact and multi-key loops run,
   at 128_fast8, 128_fast depth 1, the 2-party lownoise parties 0 and 1
   and 128_radix_reliable, each beside its byte bound.
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
   device bytes. The baked and dense forms are relaid K-major on the card,
   in place, when they are made.
7. The default preset (`make_key_pair(gen)`: 80-bit, b = 10) on the card:
   one NAND layer of 256, all correct.
8. Multi-key main path: the ceremony of
   `mktfhe_parameters_2party_lownoise` on the card (n = 500, N = 1024,
   l = 5, b = 6), `mk_encrypt` of 4096 bits, 2 chained `mk_gate_nand`
   layers on the default (compact) path, `mk_decrypt`: 4096/4096 required,
   one compact-rotation launch per party and layer; one more layer under
   `torch.profiler`; then one layer each on the chunk and per-step paths,
   bit-equal to the compact one's; then one `mk_programmable_bootstrap`
   call over 1024 messages, all correct; then at 128 messages every other
   MK gate (AND ... MUX, NOT) and one `mk_programmable_bootstrap_many`
   call with q = 2, all correct.
9. `mktfhe_parameters_2party` (the reference-fidelity preset, ~1.5% of its
   gates fail by design: at most 4 of 64 wrong), one NAND layer of 64;
   `mktfhe_parameters_4party`, one NAND layer of 1024, and
   `mktfhe_parameters_8party` (sparse-stored key), one layer of 256, all
   correct.
10. Programmable bootstrapping: `tfhe_parameters_128_pbs` (k = 2, N = 512)
   on the card, 4096 messages, the LUT [2, 0, 3, 1] applied twice
   (4096/4096 equal to f(f(m))), one `programmable_bootstrap_many` call
   with q = 2; then the fused-step entry point driven on its own: the
   rotation of those ciphertexts and 6 more (4102: a ragged last tile) step
   by step through `cmux_step_karatsuba`, each step's K-major key slice
   handed to it as the card holds it, equal to the whole-rotation kernel's
   (whose time per step on the same key and rows is printed beside) and to
   the plain steps' (each of those handed `from_kmajor` of its step alone,
   outside the CUDA events that time the step calls).
11. The radix main path: `tfhe_parameters_128_radix`, baked key, 4096 8-bit
   words, `radix_add` once to warm up and once timed, chained; wrong words
   counted (the preset's model failure is 7.9e-5 per word; more than 4 of
   4096 fails); one add under `torch.profiler`; then at 256 words one call
   each of sub, geq, min, mul, xor, shift left by 3, neg, and `radix_divide`
   at 4-bit words; then a 16-bit `radix_add`, `radix_eq`, both right
   shifts, and the signed `radix_abs`, `radix_geq_signed` and
   `radix_min_signed`, wrong words counted as above.
12. `tfhe_parameters_128_radix_reliable` under
   `tuning.override(radix_manylut=False, bs_bake_budget=0)`: compact key,
   1024 words, one timed `radix_add`, every word correct.
13. Circuits and netlist on `tfhe_parameters_128_fast`:
   `circuits.ripple_carry_add` on 512 8-bit words chained twice; a 16-bit
   Kogge-Stone adder compiled by the native scheduler (built from
   native/circuit_scheduler.cc) with `outputs=`, run at batch 256, sums
   correct and the streamed outputs equal to the dense run's.
   Phase 3 also prints the fused step's bound at B = 4096 at each of its
   plans (`[3 bound]`).
14. The wire and serving path on `tfhe_parameters_128_fast`, batch 4096:
   the threefry twin's three known-answer vectors computed on the card; a
   seeded cloud key (`compressed.make_seeded_cloud_key`) as bytes
   (`utils.serialization.dumps`), loaded onto the card and expanded (the
   bake K-major), its keyswitch masks and bootstrap step 0's masks equal
   to the same seed's expanded on the CPU; a seeded public key through the
   bytes, `encrypt_public` of 4096 bits (timed), 5 chained NAND layers on
   them (4096/4096, one rotation launch per layer), the outputs
   mod-switched to 16 bits through the bytes (4096/4096), their noise
   report healthy, re-keyed to a second user (timed, 4096/4096 under the
   second key); a 2-party lownoise ceremony through the seeded shared key
   and seeded cloud key parts as bytes, one MK NAND layer of 4096 on the
   assembled key (all correct, the MK compact kernel launched); a toy
   baked key held K-major on the card through the bytes to the CPU (the
   reference layout, equal to `from_kmajor` of the card key) and back
   (equal to the card key).
15. On phase 14's key: a 16-bit Kogge-Stone netlist job at batch 256 under
   `utils.jobs.run_checkpointed` (a checkpoint every 2 scheduled batches)
   preempted after its first chunk and resumed, bit-equal to the
   uninterrupted run, the checkpoint removed; one NAND layer of 4096 under
   `tuning.override(debug=True)` (equal to the layer without), and again
   with `blind_rotate_kernel`'s output corrupted (must raise
   `FHEDebugError`); `utils.profiling.trace` of one layer (a Chrome trace
   file); `bootstrap_roofline(128_fast, 4096, depth=1)`, its per-step
   operations floor within 1% of phase 3's row-1 bound, and the measured
   layer's share of it.
16. The multi-device layer (`tfhe_tpu_torch/parallel`): ranks of
   `python -m tfhe_tpu_torch.parallel.dryrun` as subprocesses, keys and
   inputs as files in the wire format (seeded cloud keys, expanded on
   every rank; the assembled 2-party MK key whole), made here from the
   seed and freed before the ranks start. (a) One rank over NCCL, mesh
   (1, 1): 128_fast, 4096 gates through `make_gate_nand_sharded`, bit-equal
   to `gates.gate_nand` and timed beside it and beside phase 4. (b) Ranks
   on the one card over gloo (collectives staged through host memory;
   NCCL refuses two ranks on one GPU): 2-party lownoise at mesh (1, 2) (one
   party a rank, the other fetched per gate), then at mesh (2, 2) 128_fast
   and 128_fast8 compact NAND, and 128_radix `radix_add` of 4096 words at
   (4, 1); each bit-equal to the unsharded function that rank 0 runs on
   the same inputs, decrypt-correct. (c) `make_blind_rotate_model_sharded`
   at (1, 2), then (2, 2): 1024 NAND inputs of 128_fast through the
   column-sharded key (3.1 of 6.2 GB a rank), each rank's rows bit-equal
   to `blind_rotate` (row 1) on the whole key, then extracted, keyswitched
   and decrypted. Every rank's launch counters must show its kernel (row
   1, 6 or 8; for (c) in the unsharded rotation, none in the sharded one);
   each rank prints its collective calls, staged bytes and peak memory.
   Any rank's failure or time-out fails the run.
17. The entry points on the card, each a subprocess (`python -m
   tfhe_tpu_torch.<module>`) after this process frees its tensors: `bench`
   at 128fast, 128fast8, 128 and 80, batch 4096 (each line with the
   reference bench.py's eight keys and 4096/4096 correct, its log showing
   5 rotation launches in the timed layers, the 128fast figure within 5%
   of phase 4's); `bench_suite`, every section, each bounded by
   TFHE_SUITE_SECTION_TIMEOUT_S (exit 0, no `section_*` line, the sixteen
   metric lines, each within its error limit: every output correct, but
   the radix_preset add (at most 4 wrong, as phase 11) and the lines whose
   preset fails by design, bounded from its model rate at a 1e-6 tail);
   `tools.serving_bench` over 128fast, 128fast8 and 80 (every line
   decrypt-correct at batches 1 to 4096); the six examples with
   `--production`; `tools.batch_job --params 80 --preempt-after 1` twice
   (preempted, then resumed to 64/64 correct sums).
18. The last entry-point twins, each a subprocess after this process frees
   its tensors, but (a): (a) `graft_entry.entry()` in this process:
   128_fast at batch 16 (ragged rows), its zero-filled key K-major and
   of phase 4's real key's shapes, one rotation launch, the words a zero
   key gives (a zero, b the trivial accumulator's extraction, computed
   without a rotation); (c) `tools.pbs_bench`: 4096/4096, within 5% of
   phase 10 (both time the second of two LUT calls over 4096 messages);
   (d) `tools.profile_bootstrap` at the 128 preset x 4096 and the 80-bit
   preset x 1, 8, 64: exit 0, its four lines with the reference's heads,
   and in each `trace.json` n launches each of `rotate_decompose_kernel`
   and `leaf_dots_kernel` (the benchmark's per-layer metrics time them);
   then together (checks of the paths; their rates are read under each
   other's load): (b) `python -m tfhe_tpu_torch.graft_entry --backend
   gloo` (`dryrun_multichip(8)`, eight toy ranks sharing cuda:0 over
   gloo, then `entry()`) and `dryrun_multichip(1)` over NCCL in this
   process; (e) `tools.scaling_bench`'s default (one rank over NCCL,
   batch 64 of the 128 preset) and `--virtual-devices 2` (ranks sharing
   cuda:0 over gloo at d = 1, 2: the path, not a scaling figure); every
   output correct, one rotation launch a rank.
19. The kernels' JSON line, the card's line, then the result line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

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

    def compare_dots(self, name, what, batch, m, kernel_fn, want, calls=1):
        """compare() for a kernel whose `calls` C entry calls run the dots
        at M output blocks: the `dots.clustered` and `dots.row_tile.<r>`
        counts that kernel_fn() adds must be the rules' at this batch and
        M, and the line names the `r` and `c` they show."""
        got, seen, rows_seen = clustered_calls(kernel_fn)
        rows, rule = dots_tile(batch, m)
        check(seen == calls * int(rule > 1),
              f"{name} at {what}: dots.clustered counted {seen} over "
              f"{calls} calls, the rule at B={batch} says c={rule}")
        check(rows_seen == {rows: calls},
              f"{name} at {what}: dots.row_tile counted {rows_seen} over "
              f"{calls} calls, the rule at B={batch} M={m} says r={rows}")
        self.compare(name, f"{what} r={rows} c={2 if seen else 1}", got,
                     want)

    def timed(self, name, what, kernel_fn, plain_fn, bound, card,
              dots=None):
        """dots: for a kernel that runs the int8 dots, (executed, useful
        operations, the `torch._int_mm` yardstick's ms, the batch rows of
        its blocks, the blocks of its clusters) of the timed call; one more
        call of kernel_fn shows the blocks by its `dots.clustered` count,
        which must agree.
        The operation counts come from the tables the kernel reads, not from
        the card, so they go on this line only; the yardstick is measured and
        also goes into the kernels record."""
        ent = self.entries[name]
        ent["ms"] = cuda_ms(kernel_fn)
        ent["plain_ms"] = cuda_ms(plain_fn)
        ent["bound_ms"], ent["bound_by"] = bound
        extra = "no single library call"
        if dots is not None:
            executed, useful, mm_ms, rows, cluster = dots
            seen = 2 if clustered_calls(kernel_fn)[1] else 1
            check(seen == cluster, f"{name} at {what}: dots.clustered shows "
                  f"c={seen}, expected c={cluster}")
            sec = ent["ms"] / 1e3
            ent["int_mm_products_ms"] = mm_ms
            extra = (f"dots r={rows} c={cluster}: "
                     f"{executed:.4g} int8 ops executed, {useful:.4g} useful, "
                     f"counted from the tables (x{executed / useful:.3f}): "
                     f"{executed / sec / 1e12:.1f}"
                     f" TOP/s executed, {useful / sec / 1e12:.1f} useful | "
                     f"torch._int_mm over the same products (products only, "
                     f"a yardstick): {mm_ms:.3f} ms; no single library call")
        print(f"[3 timing] {name} {what}: kernel {ent['ms']:.3f} ms, plain "
              f"{ent['plain_ms']:.3f} ms, bound {ent['bound_ms']:.4f} ms by "
              f"{ent['bound_by']} | {extra} | {card}", flush=True)


def dots_ops(tables, batch: int, cols: int, useful: float, steps: int = 1,
             tile=None):
    """(executed, useful, int_mm ms, r, c) of `steps` dots launches at this
    batch: every product of the kernel's table once over the `cols` key
    columns it serves (all K*4*T of a single-key step, the 4*T of a
    multi-key block), the summed time of `torch._int_mm` over the same
    products (one timed call per distinct [batch, depth] x [depth, cols]
    shape, times its count), the batch rows of a block and the blocks of
    the launches' clusters (`tile` = (r, c), else the dots launches' own
    rules at this batch and the table's M)."""
    from collections import Counter

    from tfhe_tpu_torch.ops.dots import CHUNK

    depths = Counter(pr[2] * pr[3] * CHUNK for pr in tables.products)
    executed = 2.0 * batch * cols * sum(d * c for d, c in depths.items())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm_ms = 0.0
    for depth, count in depths.items():
        a, b = rand_i8(gen, (batch, depth)), rand_i8(gen, (depth, cols))
        mm_ms += count * cuda_ms(lambda: torch._int_mm(a, b), reps=10)
    return (steps * executed, steps * useful, steps * mm_ms,
            *(tile or dots_tile(batch, tables.m)))


def dots_tile(batch: int, m: int):
    """(r, c): the batch rows of a dots block at this batch and M
    (`ops/dots.py:row_tile`) and the blocks of the launch's clusters (c =
    1: a plain launch)."""
    from tfhe_tpu_torch.ops import dots

    rows = dots.row_tile(m, batch)
    return rows, dots.cluster_size(-(-batch // rows))


def clustered_calls(fn):
    """fn()'s result, the `dots.clustered` count it added (its C entry
    calls whose dots launches ran in clusters) and the `dots.row_tile.<r>`
    counts it added, as {r: calls}."""
    from tfhe_tpu_torch.instrument import counts

    prefix = "dots.row_tile."

    def tiles():
        return {int(k[len(prefix):]): n for k, n in counts().items()
                if k.startswith(prefix)}

    before, rows_before = counts().get("dots.clustered", 0), tiles()
    out = fn()
    rows = {r: n - rows_before.get(r, 0) for r, n in tiles().items()
            if n != rows_before.get(r, 0)}
    return out, counts().get("dots.clustered", 0) - before, rows


def phase3(gen, card) -> Kernels:
    from tfhe_tpu_torch.ops import cmux_step, compact
    from tfhe_tpu_torch.ops.blind_rotate import (
        blind_rotate_kernel,
        blind_rotate_plain,
        dots_tables,
    )
    from tfhe_tpu_torch.ops.dots import to_kmajor
    from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba

    ks = Kernels()
    src = "tfhe_tpu/ops/pallas_cmux.py"
    ks.entry("blind_rotate", "blind_rotate.cu", f"{src}:645")[
        "also_replaces"] = f"{src}:1420"
    ks.entry("blind_rotate_compact", "compact.cu", f"{src}:1790")
    ks.entry("expand_karatsuba_step", "compact.cu", f"{src}:1737")
    ks.entry("rotate_decompose", "cmux_step.cu", f"{src}:39")
    ks.entry("cmux_matmul", "cmux_step.cu", f"{src}:92")
    phase3_rows(ks, gen, card)

    def shape(k1, n, l, b, depth, n_steps, batch):
        return (f"K={k1} N={n} l={l} b={b} depth={depth} steps={n_steps} "
                f"B={batch}")

    # the baked Karatsuba rotation (rows 1-2), with the b = 10 shape
    for name, *dims in [("128_fast", 5, 256, 2, 8, 1, 8, 256),
                        ("128_fast", 5, 256, 2, 8, 1, 8, 300),
                        ("toy", 2, 256, 3, 7, 1, 8, 64),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 64),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 70),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 130),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 200),
                        ("cggi128", 2, 1024, 3, 7, 2, 2, 4096),
                        ("128_pbs", 3, 512, 3, 7, 2, 4, 70),
                        ("128_radix_reliable", 2, 1024, 4, 6, 2, 4, 70),
                        ("80bit_b10", 2, 1024, 2, 10, 2, 4, 64)]:
        acc, key, bara_t, kw = random_case(gen, *dims)
        key_km = to_kmajor(key)
        ks.compare_dots("blind_rotate", f"{name} {shape(*dims)}", dims[-1],
                        dims[1] // T,
                        lambda: blind_rotate_kernel(acc, key_km, bara_t, **kw),
                        blind_rotate_plain(acc, key, bara_t, **kw))

    # the expansion kernel (row 6), in both layouts, against the plain
    # version and the bake
    for name, *dims in [("128_fast", 5, 256, 2, 8, 1),
                        ("128_fast8", 9, 128, 2, 8, 0),
                        ("N1024_l4_b6_depth2", 2, 1024, 4, 6, 2)]:
        _, limbs, _, kw = random_case(gen, *dims, 2, 1, form="compact")
        kw = dict(t=T, plan=kw["plan"])
        got = compact.expand_step_kernel(limbs[1], **kw)
        what = "{} K={} N={} l={} b={} depth={}".format(name, *dims)
        want = compact.expand_step_plain(limbs[1], **kw)
        ks.compare("expand_karatsuba_step", what, got, want)
        ks.compare("expand_karatsuba_step", what + " (bake_karatsuba)", got,
                   bake_karatsuba(limbs, T, kw["plan"])[1])
        ks.compare("expand_karatsuba_step", what + " (K-major)",
                   compact.expand_step_kernel(limbs[1], kmajor=True, **kw),
                   to_kmajor(want))
    # the compact rotation (row 6)
    for name, *dims in [("128_fast8", 9, 128, 2, 8, 0, 6, 256),
                        ("128_fast8", 9, 128, 2, 8, 0, 6, 300),
                        ("128_fast", 5, 256, 2, 8, 1, 6, 300),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 64),
                        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 70),
                        ("128_radix_reliable", 2, 1024, 4, 6, 2, 4, 70)]:
        acc, limbs, bara_t, kw = random_case(gen, *dims, form="compact")
        ks.compare_dots(
            "blind_rotate_compact", f"{name} {shape(*dims)}", dims[-1],
            dims[1] // T,
            lambda: compact.blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                        **kw),
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
        key_km = to_kmajor(key)
        ks.compare_dots(
            "cmux_matmul", what, dims[-1], dims[1] // T,
            lambda: cmux_step.cmux_matmul_kernel(digits, acc, key_km[1], **mm),
            cmux_step.cmux_matmul_plain(digits, acc, key[1], **mm))
        ks.compare_dots(
            "cmux_matmul", what + " (whole rotation)", dims[-1],
            dims[1] // T,
            lambda: cmux_step.blind_rotate_dense_kernel(acc, key_km, bara_t,
                                                        **kw),
            cmux_step.blind_rotate_dense_plain(acc, key, bara_t, **kw),
            calls=dims[-2])

    # timings at B = 4096 over TIMED_STEPS steps, with the bound of the work
    steps = TIMED_STEPS
    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 1, steps, BATCH)
    key_km = to_kmajor(key)
    io = nbytes(acc, acc, key, bara_t)  # acc read once, written once
    pt, cols = 5 * 2 * T, 5 * 4 * T
    dots = 2.0 * kw["plan"].macs_superblocks * BATCH * cols * pt * steps
    ks.timed("blind_rotate", f"128_fast B={BATCH}, {steps} steps",
             lambda: blind_rotate_kernel(acc, key_km, bara_t, **kw),
             lambda: blind_rotate_plain(acc, key, bara_t, **kw),
             bound_ms(io, dots, PEAK_INT8_OPS_PER_S), card,
             dots_ops(dots_tables(kw["plan"], 5, 2, T), BATCH, cols,
                      dots / steps, steps))
    del key, key_km

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
             bound_ms(io, dots, PEAK_INT8_OPS_PER_S), card,
             dots_ops(dots_tables(kw["plan"], 9, 2, T), BATCH, cols,
                      dots / steps, steps))

    del acc, limbs, bara_t
    phase3_expand(ks, gen, card)

    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 0, steps, BATCH,
                                       form="dense")
    key_km = to_kmajor(key)
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
        lambda: [cmux_step.cmux_matmul_kernel(digits, acc, key_km[s], **mm)
                 for s in range(steps)],
        lambda: [cmux_step.cmux_matmul_plain(digits, acc, key[s], **mm)
                 for s in range(steps)],
        bound_ms(steps * nbytes(digits, acc, acc, key[0]), steps * dots,
                 PEAK_INT8_OPS_PER_S), card,
        dots_ops(cmux_step._dense_dots_tables(5, 2, 256 // T, (0,), T), BATCH,
                 key.shape[2], dots, steps))
    phase3_mk(ks, gen, card)
    phase3_fused(ks, gen, card)
    return ks


# The expansion's shapes on the paths (name: total_rows, P, K, N, plan M,
# depth, b): each compact step of 128_fast8 and 128_fast at depth 1, a
# 2-party lownoise party's loop (party 0: K = 2, NZ = 4; party 1: K = 3,
# NZ = 7; l = 5, one column) and 128_radix_reliable's compact step.
def expand_shapes():
    from tfhe_tpu_torch.mk.internals import active_plan
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    def mk(party):
        nz = active_plan(party, 2, True)[1]
        return (len(nz) * 5, 1, MK_N, karatsuba_plan(MK_N // T, 2, 6))

    shapes = {
        "128_fast8": (9 * 2, 9, 128, karatsuba_plan(1, 0, 8)),
        "128_fast_depth1": (5 * 2, 5, 256, karatsuba_plan(2, 1, 8)),
        "MK_2party_party0": mk(0),
        "MK_2party_party1": mk(1),
        "128_radix_reliable": (2 * 4, 2, 1024, karatsuba_plan(8, 2, 6)),
    }
    return shapes


def expand_case(gen, name):
    """Random limbs of one step at an expansion shape, the plan, and the
    least time of one expansion: its limbs read once, its output written
    once; per output byte about 3 integer operations (select, split,
    store)."""
    p_rows, k1, n, plan = expand_shapes()[name]
    limbs = rand_i8(gen, (4, p_rows, k1, 2 * n))
    out_bytes = plan.total_rows * p_rows * T * k1 * 4 * T
    return limbs, plan, bound_ms(nbytes(limbs) + out_bytes, 3.0 * out_bytes,
                                 PEAK_ALU_OPS_PER_S)


def phase3_expand(ks, gen, card):
    """The expansion kernel timed K-major, the layout the compact and
    multi-key loops run, at each path's shape beside its byte bound; the
    record's own kernel and plain times are 128_fast8's."""
    from tfhe_tpu_torch.ops import compact

    ent = ks.entries["expand_karatsuba_step"]
    ent["shapes"] = {}
    for name in expand_shapes():
        limbs, plan, (bound, by) = expand_case(gen, name)
        kw = dict(t=T, plan=plan)
        ms = cuda_ms(lambda: compact.expand_step_kernel(limbs, kmajor=True,
                                                        **kw), reps=20)
        ent["shapes"][name] = {"ms": ms, "bound_ms": bound, "bound_by": by}
        print(f"[3 timing] expand_karatsuba_step {name} K-major: kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms by {by} "
              f"({100 * bound / ms:.1f}% of it) | {card}", flush=True)
        if name == "128_fast8":
            ks.timed("expand_karatsuba_step", "128_fast8, one step, K-major",
                     lambda: compact.expand_step_kernel(limbs, kmajor=True,
                                                        **kw),
                     lambda: compact.expand_step_plain(limbs, **kw),
                     (bound, by), card)


# The digit-row shapes (name, K, N, l, b, depth, balanced): the presets'
# steps, single-key and multi-key (the 8-party preset's l = 8, b = 4).
ROW_SHAPES = {
    "128_fast": (5, 256, 2, 8, 1, True),
    "128_fast8": (9, 128, 2, 8, 0, True),
    "128_pbs": (3, 512, 3, 7, 2, True),
    "128_radix": (2, 1024, 3, 7, 2, True),
    "N1024_depth2": (2, 1024, 3, 7, 2, False),
    "128_radix_reliable": (2, 1024, 4, 6, 2, True),
    "80bit_b10": (2, 1024, 2, 10, 2, False),
    "MK_2party_K2": (2, 1024, 5, 6, 2, False),
    "MK_2party_K3": (3, 1024, 5, 6, 2, False),
    "MK_8party_K9": (9, 1024, 8, 4, 2, False),
}
# where the timings are taken, at B = 4096 (256 for 8 parties)
ROW_TIMED = ("128_fast", "128_fast8", "128_pbs", "128_radix", "MK_2party_K2",
             "MK_2party_K3", "MK_8party_K9")


def rows_case(gen, name, batch):
    """Random acc and bara (0 in row 0, negatives) for one digit-row shape;
    returns (acc, bara, combos, lhs_rows, kw, first defined byte)."""
    from tfhe_tpu_torch.ops.blind_rotate import (
        digit_row_defined,
        kernel_tables,
    )
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan
    from tfhe_tpu_torch.tgsw import decomp_offset

    k1, n, l, b, depth, balanced = ROW_SHAPES[name]
    combos, _, _, lhs_rows = kernel_tables(karatsuba_plan(n // T, depth, b),
                                           k1 * l, T)
    kw = dict(l=l, b=b, t=T, offset=decomp_offset(l, b, balanced))
    return (rand_i32(gen, (batch, k1, n)), rand_bara(gen, n, 2, batch)[1],
            combos, lhs_rows, kw, digit_row_defined(b, n // T, k1 * l * T))


def rows_bound(acc, combos, lhs_rows, kw, first):
    """The least time of one digit-row launch: acc read once, the defined
    digit bytes written once; operations: per digit a shift, a mask and a
    subtract, per combo lane its adds and (two-limb) split."""
    bsz, k1, n = acc.shape
    l = kw["l"]
    written = bsz * (lhs_rows * k1 * l * T - first)
    lanes = bsz * k1 * n * l
    ops = 3.0 * lanes + lanes // (n // T) * sum(
        bin(mask).count("1") + 4 * two for _, mask, two, _ in combos)
    return bound_ms(nbytes(acc) + written + 4 * bsz, ops, PEAK_ALU_OPS_PER_S)


def phase3_rows(ks, gen, card):
    """The first launch of every rotation step alone: rotate_decompose_kernel
    (digit_rows_kernel) against digit_rows_plain, then its time at the
    presets' shapes beside its bound."""
    from tfhe_tpu_torch.ops.blind_rotate import (
        digit_rows_kernel,
        digit_rows_plain,
    )

    name = "rotate_decompose_rows"
    src = "tfhe_tpu/ops/pallas_cmux.py"
    ks.entry(name, "cmux_kernels.cuh", f"{src}:334")["also_replaces"] = \
        f"{src}:372"
    for shape, batch in [("128_fast", 256), ("128_fast", 300),
                         ("128_fast8", 300), ("N1024_depth2", 70),
                         ("128_pbs", 70), ("128_radix_reliable", 70),
                         ("80bit_b10", 70), ("MK_2party_K2", 70),
                         ("MK_2party_K3", 70), ("MK_8party_K9", 70)]:
        acc, bara, combos, lhs_rows, kw, first = rows_case(gen, shape, batch)
        got = digit_rows_kernel(acc, bara, combos, lhs_rows, **kw)
        want = digit_rows_plain(acc, bara, combos, lhs_rows, **kw)
        what = "{} K={} N={} l={} b={} depth={} B={}".format(
            shape, *ROW_SHAPES[shape][:5], batch)
        ks.compare(name, what + ("" if not first else
                                 f" (bytes from {first}: b > 8)"),
                   got[:, first:], want[:, first:])

    ent = ks.entries[name]
    ent["shapes"] = {}
    for shape in ROW_TIMED:
        batch = 256 if shape == "MK_8party_K9" else BATCH
        acc, bara, combos, lhs_rows, kw, first = rows_case(gen, shape, batch)
        ms = cuda_ms(lambda: digit_rows_kernel(acc, bara, combos, lhs_rows,
                                               **kw), reps=10)
        bound, by = rows_bound(acc, combos, lhs_rows, kw, first)
        ent["shapes"][shape] = {"B": batch, "ms": ms, "bound_ms": bound,
                                "bound_by": by}
        print(f"[3 timing] {name} {shape} B={batch}: kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f}% of "
              f"it) | {card}", flush=True)
        if shape == "128_fast":
            ks.timed(name, f"128_fast B={batch}",
                     lambda: digit_rows_kernel(acc, bara, combos, lhs_rows,
                                               **kw),
                     lambda: digit_rows_plain(acc, bara, combos, lhs_rows,
                                              **kw),
                     (bound, by), card)


def phase3_fused(ks, gen, card):
    """The fused Karatsuba step (one launch, the K-major key step) against
    its plain version (the reference-layout step) and against the
    whole-rotation kernel, then its time at 128_fast, B = 4096, with the
    `torch._int_mm` yardstick over its products."""
    from tfhe_tpu_torch.ops.blind_rotate import (
        blind_rotate_kernel,
        dots_tables,
    )
    from tfhe_tpu_torch.ops.dots import ROW_TILE, to_kmajor
    from tfhe_tpu_torch.ops.fused_step import (
        cmux_step_karatsuba_kernel,
        cmux_step_karatsuba_plain,
    )
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    name = "cmux_step_karatsuba"
    ks.entry(name, "fused_step.cu", f"{MK_SRC}:185")

    def chain(fn, acc, key, bara_t, kw):
        for s in range(key.shape[0]):
            acc = fn(acc, key[s], bara_t[s], **kw)
        return acc

    steps = TIMED_STEPS
    for preset, *dims in FUSED_PLANS:
        acc, key, bara_t, kw = random_case(gen, *dims, steps, 70)
        key_km = to_kmajor(key)
        what = "{} K={} N={} l={} b={} depth={} B=70".format(preset, *dims)
        got = cmux_step_karatsuba_kernel(acc, key_km[1], bara_t[1], **kw)
        ks.compare(name, what + " (plain step)", got,
                   cmux_step_karatsuba_plain(acc, key[1], bara_t[1], **kw))
        ks.compare(name, what + " (blind_rotate_kernel, one step)", got,
                   blind_rotate_kernel(acc, key_km[1:2], bara_t[1:2], **kw))
        ks.compare(name, what + f" ({steps} steps in a row)",
                   chain(cmux_step_karatsuba_kernel, acc, key_km, bara_t, kw),
                   blind_rotate_kernel(acc, key_km, bara_t, **kw))

    # one step's bound at B = 4096 at each plan: the useful operations of
    # step_operations; the accumulator read and written, the key step and
    # bara read once
    for preset, k1, n, l, b, depth in FUSED_PLANS:
        plan = karatsuba_plan(n // T, depth, b)
        useful, _ = step_operations(SimpleNamespace(
            mask_size=k1 - 1, decomp_length=l, block=T, plan=plan), BATCH)
        io = 2 * BATCH * k1 * n * 4 + plan.total_rows * (k1 * l * T) \
            * (k1 * 4 * T) + BATCH * 4
        ms, by = bound_ms(io, useful, PEAK_INT8_OPS_PER_S)
        print(f"[3 bound] {name} {preset} B={BATCH}: one step's bound "
              f"{ms:.4f} ms by {by} ({useful:.4g} useful int8 operations, "
              f"{io / 1e6:.1f} MB) | {card}", flush=True)

    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 1, steps, BATCH)
    key_km = to_kmajor(key)
    # every step reads acc and writes a new one; the key and bara once
    io = steps * nbytes(acc, acc) + nbytes(key, bara_t)
    cols, pt = key.shape[2], 5 * 2 * T
    dots = 2.0 * kw["plan"].macs_superblocks * BATCH * cols * pt * steps
    ks.timed(name, f"128_fast B={BATCH}, {steps} steps (one launch each)",
             lambda: chain(cmux_step_karatsuba_kernel, acc, key_km, bara_t,
                           kw),
             lambda: chain(cmux_step_karatsuba_plain, acc, key, bara_t, kw),
             bound_ms(io, dots, PEAK_INT8_OPS_PER_S), card,
             dots_ops(dots_tables(kw["plan"], 5, 2, T), BATCH, cols,
                      dots / steps, steps, tile=(ROW_TILE, 1)))


# The fused step's plans (name, K, N, l, b, depth): 128_fast, 128_radix,
# 128_radix_reliable, 128_pbs and the 80-bit preset (b = 10).
FUSED_PLANS = [("128_fast", 5, 256, 2, 8, 1),
               ("128_radix", 2, 1024, 3, 7, 2),
               ("128_radix_reliable", 2, 1024, 4, 6, 2),
               ("128_pbs", 3, 512, 3, 7, 2),
               ("80bit_b10", 2, 1024, 2, 10, 2)]


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
    from tfhe_tpu_torch.ops import compact, mk_cmux
    from tfhe_tpu_torch.ops.dots import from_kmajor
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
        (2, 0, 5, 6, 2, 130, True, False),  # 128-row tiles: the second's
        (2, 1, 5, 6, 2, 130, True, False),  # second warpgroup past B
        (2, 1, 5, 6, 2, 200, True, False),
    ]
    for parties, party, l, b, n_steps, batch, progressive, sparse in cases:
        acc, limbs, bara_t, kw = mk_case(gen, parties, party, l, b, n_steps,
                                         batch, progressive, sparse)
        what = (f"{parties} parties, party {party}, l={l} b={b} "
                f"K={acc.shape[1]} NZ={len(kw['nz'])} steps={n_steps} "
                f"B={batch}" + (" sparse-stored" if sparse else "")
                + ("" if progressive else " full plan"))
        e_chunk = expand_all(  # K-major, the layout the kernels read
            limbs, kw, lambda st, **ekw: mk_cmux.expand_sparse(
                st, preselected=True, **ekw))
        e_ref = expand_all(
            limbs, kw, lambda st, t, plan, nz, l:
            expand_karatsuba_sparse(st, t, plan, nz, l, True))
        ks.compare("expand_karatsuba_step", what + " (sparse expansion)",
                   from_kmajor(e_chunk), e_ref)
        ks.compare("expand_karatsuba_step",
                   what + " (sparse expansion, reference layout)",
                   expand_all(limbs, kw, lambda st, t, plan, nz, l:
                              compact.expand_step_kernel(
                                  st.contiguous().reshape(
                                      4, len(nz) * l, 1, st.shape[-1]),
                                  t=t, plan=plan)), e_ref)
        m = MK_N // T
        ks.compare_dots(
            "cmux_step_sparse", what, batch, m,
            lambda: mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[1],
                                                    bara_t[1], **kw),
            mk_cmux.cmux_step_sparse_plain(acc, e_ref[1], bara_t[1], **kw))
        ks.compare_dots(
            "mk_blind_rotate_chunk", what, batch, m,
            lambda: mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t,
                                                         **kw),
            mk_cmux.mk_blind_rotate_chunk_plain(acc, e_ref, bara_t, **kw))
        ks.compare_dots(
            "mk_blind_rotate_compact", what, batch, m,
            lambda: mk_cmux.mk_blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                           **kw),
            mk_cmux.mk_blind_rotate_compact_plain(acc, limbs, bara_t, **kw))
        del e_chunk, e_ref

    # timings: party 1's plan of 2-party lownoise (K = 3, NZ = 7), B = 4096
    steps = TIMED_STEPS
    acc, limbs, bara_t, kw = mk_case(gen, 2, 1, 5, 6, steps, BATCH)
    e_chunk = expand_all(limbs, kw, lambda st, **ekw: mk_cmux.expand_sparse(
        st, preselected=True, **ekw))
    e_ref = from_kmajor(e_chunk)
    nzn, lt = len(kw["nz"]), kw["l"] * T
    # each of the plan's digit x key tile products once: [B, l*T] x [l*T, 4T]
    dots = 2.0 * kw["plan"].macs_superblocks * nzn * BATCH * lt * 4 * T * steps
    ops = dots_ops(mk_cmux._mk_dots_tables(kw["plan"], kw["l"], acc.shape[1],
                                           T, kw["nz"]),
                   BATCH, 4 * T, dots / steps, steps)
    what = f"2-party lownoise party 1 (K=3, NZ=7) B={BATCH}, {steps} steps"
    ks.timed(
        "cmux_step_sparse", what + " (one call each)",
        lambda: [mk_cmux.cmux_step_sparse_kernel(acc, e_chunk[s], bara_t[s],
                                                 **kw) for s in range(steps)],
        lambda: [mk_cmux.cmux_step_sparse_plain(acc, e_ref[s], bara_t[s],
                                                **kw) for s in range(steps)],
        bound_ms(steps * nbytes(acc, acc, e_chunk[0], bara_t[0]), dots,
                 PEAK_INT8_OPS_PER_S), card, ops)
    ks.timed(
        "mk_blind_rotate_chunk", what,
        lambda: mk_cmux.mk_blind_rotate_chunk_kernel(acc, e_chunk, bara_t,
                                                     **kw),
        lambda: mk_cmux.mk_blind_rotate_chunk_plain(acc, e_ref, bara_t,
                                                    **kw),
        bound_ms(nbytes(acc, acc, e_chunk, bara_t), dots,
                 PEAK_INT8_OPS_PER_S), card, ops)
    ks.timed(
        "mk_blind_rotate_compact", what,
        lambda: mk_cmux.mk_blind_rotate_compact_kernel(acc, limbs, bara_t,
                                                       **kw),
        lambda: mk_cmux.mk_blind_rotate_compact_plain(acc, limbs, bara_t,
                                                      **kw),
        bound_ms(nbytes(acc, acc, limbs, bara_t), dots, PEAK_INT8_OPS_PER_S),
        card, ops)


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
    from tfhe_tpu_torch.ops import reset_launches

    return reset_launches()


def read_counts(wrappers) -> dict:
    from tfhe_tpu_torch.instrument import counts

    launched = counts(wrappers)
    return {name: launched.get(name, 0) for name in wrappers}


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


def step_by_step(step_fn, acc, key_km, bara_t, kw, relay=True):
    """`step_fn(acc, key_step, bara, **kw)`, one CMUX step, over every step
    of a K-major key; with `relay` each step is handed over in the
    reference layout (the plain versions): the bytes of that step alone,
    never a second copy of the key. Returns the accumulator and the summed
    device ms of the step calls alone, each step's relayout outside the CUDA
    events that time it."""
    from tfhe_tpu_torch.ops.dots import from_kmajor

    spans = []
    for s in range(key_km.shape[0]):
        step = from_kmajor(key_km[s]) if relay else key_km[s]
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        acc = step_fn(acc, step, bara_t[s], **kw)
        t1.record()
        spans.append((t0, t1))
    torch.cuda.synchronize()
    return acc, sum(t0.elapsed_time(t1) for t0, t1 in spans)


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
    check(tuple(bk.baked.shape) == (630, 5, 4, T, 3840) and bk.depth == 1
          and bk.layout == "kmajor",
          f"unexpected baked key {tuple(bk.baked.shape)} depth {bk.depth}")

    wrappers = reset_counts()
    (ct_x, ct_y), _, correct, chain_s = nand_chain(tp, ck, sk, gen, LAYERS,
                                                   BATCH, dev)
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    launches = counts["blind_rotate"]
    check(launches == LAYERS,
          f"{launches} kernel launches in {LAYERS} NAND layers")
    # the rotation's first launch of each of its n steps is the digit rows
    n_steps = bk.baked.shape[0]
    check(counts == {"blind_rotate": LAYERS,
                     "rotate_decompose_rows": LAYERS * n_steps},
          f"the baked path launched other kernels: {counts}")
    ks.entries["blind_rotate"]["launches"] = launches
    ks.entries["rotate_decompose_rows"]["launches"] = \
        counts["rotate_decompose_rows"]
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
    want_rot, _ = step_by_step(
        lambda a, e, br, **k: blind_rotate_plain(a, e[None], br[None], **k),
        acc0, bk.baked, bara_t, kw)
    torch.cuda.synchronize()
    check(torch.equal(got_rot, want_rot),
          "kernel != plain on the real 128_fast key")
    print(f"[4 main path] 128_fast keygen {keygen_s:.2f} s | {LAYERS} NAND "
          f"layers x {BATCH} in {chain_s:.3f} s = "
          f"{BATCH * LAYERS / chain_s:.1f} gates/s | "
          f"{correct}/{BATCH} correct | kernel launches {launches} "
          f"(expected {LAYERS}), digit-row launches "
          f"{counts['rotate_decompose_rows']} | peak {peak_gb:.2f} GB | "
          f"real-key rotation "
          f"kernel=plain on {small} | {card}", flush=True)
    # the real key's shapes, which entry()'s fake key must have (phase 18)
    shapes = {"baked": tuple(bk.baked.shape), "depth": bk.depth,
              "layout": bk.layout,
              "keyswitch": tuple(ck.keyswitch_key.table_limbs.shape)}
    return BATCH * LAYERS / chain_s, shapes


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
    check(counts["rotate_decompose_rows"] == LAYERS * bk.baked.shape[0]
          and sum(counts.values()) == 2 * LAYERS
          + counts["rotate_decompose_rows"],
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

    n_lwe = params.lwe_size
    forms = [  # (name, tuning, kernels that must launch once per step/layer)
        ("baked depth 1", dict(karatsuba_depth=1),
         {"blind_rotate": 1, "rotate_decompose_rows": n_lwe}),
        ("compact", dict(karatsuba_depth=1, bs_bake_budget=0),
         {"blind_rotate_compact": 1, "expand_karatsuba_step": 1,
          "rotate_decompose_rows": n_lwe}),
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


def mk_nand_chain(mk, ck, sks, gen, layers, batch, dev, allowed=0):
    """mk_encrypt, `layers` chained mk_gate_nand, mk_decrypt; at most
    `allowed` wrong. Returns the inputs, the first layer's output, the
    number correct and the chain's seconds."""
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
    check(correct >= batch - allowed,
          f"{correct}/{batch} MK gates decrypt correctly")
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
                "expand_karatsuba_step": MK_LAYERS * parties,
                "rotate_decompose_rows": MK_LAYERS * parties * n_lwe}
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
                    "expand_karatsuba_step": parties * n_lwe,
                    "rotate_decompose_rows": parties * n_lwe}
        check(counts == expected,
              f"MK {name} path launches {counts}, expected {expected}")
        ks.entries[kernel]["launches"] = counts[kernel]
        check(torch.equal(out.a, first.a) and torch.equal(out.b, first.b),
              f"MK {name} path output differs from the compact path's")
        print(f"[8 MK paths] {name}: one NAND layer x {BATCH} in "
              f"{layer_s:.3f} s, {layer_s / (parties * n_lwe) * 1e3:.3f} ms "
              f"per step | launches {counts} | a and b bit-equal to the "
              f"compact path's | {card}", flush=True)

    # one multi-key programmable bootstrap on the same key
    from tfhe_tpu_torch import pbs

    space, n_msgs = 4, 1024
    msgs = torch.arange(n_msgs, device=dev) % space
    lut = torch.tensor([2, 0, 3, 1], device=dev)
    ct = pbs.mk_encrypt_pbs(gen, sks, msgs, space)
    wrappers = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pbs.mk_programmable_bootstrap(ck.bootstrap_key, ck.keyswitch_keys,
                                        lut, ct, space)
    torch.cuda.synchronize()
    pbs_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(counts.get("mk_blind_rotate_compact") == parties,
          f"MK PBS launches {counts}")
    correct = int((pbs.mk_decrypt_pbs(sks, out, space) == lut[msgs]).sum())
    check(out.a.shape == (n_msgs, parties, n_lwe), "MK PBS output shape")
    check(correct == n_msgs, f"MK PBS: {correct}/{n_msgs} correct")
    print(f"[8 MK PBS] mk_programmable_bootstrap, LUT [2, 0, 3, 1] over "
          f"{n_msgs} messages in {pbs_s:.3f} s = {n_msgs / pbs_s:.1f} LUTs/s "
          f"| {correct}/{n_msgs} correct | launches {counts} | {card}",
          flush=True)
    mk_more_on_card(mk, pbs, ck, sks, gen, dev, card)


def mk_more_on_card(mk, pbs, ck, sks, gen, dev, card):
    """On the 2-party lownoise key, at a batch of 128, one call each: every
    MK gate other than NAND and the MK many-LUT; every output correct."""
    batch = 128
    idx = torch.arange(batch, device=dev)
    bx, by, bz = idx % 2 == 0, idx % 3 == 0, idx % 5 < 2
    cx, cy, cz = (mk.mk_encrypt(gen, sks, bits) for bits in (bx, by, bz))
    gates = [
        ("and", lambda: mk.mk_gate_and(ck, cx, cy), bx & by),
        ("or", lambda: mk.mk_gate_or(ck, cx, cy), bx | by),
        ("xor", lambda: mk.mk_gate_xor(ck, cx, cy), bx ^ by),
        ("xnor", lambda: mk.mk_gate_xnor(ck, cx, cy), ~(bx ^ by)),
        ("nor", lambda: mk.mk_gate_nor(ck, cx, cy), ~(bx | by)),
        ("andny", lambda: mk.mk_gate_andny(ck, cx, cy), ~bx & by),
        ("andyn", lambda: mk.mk_gate_andyn(ck, cx, cy), bx & ~by),
        ("orny", lambda: mk.mk_gate_orny(ck, cx, cy), ~bx | by),
        ("oryn", lambda: mk.mk_gate_oryn(ck, cx, cy), bx | ~by),
        ("not", lambda: mk.mk_gate_not(ck, cx), ~bx),
        ("mux", lambda: mk.mk_gate_mux(ck, cx, cy, cz),
         torch.where(bx, by, bz)),
    ]
    results = []
    for name, fn, want in gates:
        correct = int((mk.mk_decrypt(sks, fn()) == want).sum())
        check(correct == batch, f"MK {name}: {correct}/{batch} correct")
        results.append(f"{name} {correct}/{batch}")
    space, q = 4, 2
    msgs = idx % space
    tables = torch.tensor([[2, 0, 3, 1], [1, 3, 0, 2]], device=dev)
    wrappers = reset_counts()
    out = pbs.mk_programmable_bootstrap_many(
        ck.bootstrap_key, ck.keyswitch_keys, tables,
        pbs.mk_encrypt_pbs(gen, sks, msgs, space), space, q)
    got = pbs.mk_decrypt_pbs(sks, out, space)
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(tuple(got.shape) == (batch, q), "MK many-LUT output shape")
    many_ok = [int((got[:, r] == tables[r][msgs]).sum()) for r in range(q)]
    check(many_ok == [batch] * q, f"MK many-LUT: {many_ok} of {batch}")
    print(f"[8 MK more] gates on {batch}: {', '.join(results)} | "
          f"mk_programmable_bootstrap_many q={q}: {many_ok} of {batch} "
          f"correct, launches {counts} | {card}", flush=True)


def phase9_mk_more_parties(tp, dev, card):
    from tfhe_tpu_torch import mk

    # the reference-fidelity 2-party preset fails ~1.5% of its gates by
    # design (mk/api.py): 64 gates expect about 1 wrong, 4 are allowed
    for parties, make_params, batch, sparse, allowed in [
            (2, mk.mktfhe_parameters_2party, 64, False, MAX_WRONG),
            (4, mk.mktfhe_parameters_4party, 1024, False, 0),
            (8, mk.mktfhe_parameters_8party, 256, True, 0)]:
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
                                               dev, allowed)
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        check(counts.get("mk_blind_rotate_compact") == parties,
              f"{parties}-party launches {counts}")
        preset = make_params.__name__.removeprefix("mktfhe_parameters_")
        print(f"[9 MK {preset}] ceremony {ceremony_s:.2f} s | key "
              f"{key_bytes / 1e6:.1f} MB"
              f"{' (sparse-stored)' if sparse else ''} | one NAND layer x "
              f"{batch} in {layer_s:.3f} s = {batch / layer_s:.1f} gates/s, "
              f"{layer_s / (parties * params.lwe_size) * 1e3:.3f} ms per "
              f"step | {correct}/{batch} correct | launches {counts} | peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
              flush=True)
        del ck, bk


def fresh_device(dev):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def key_mb(ck) -> float:
    return nbytes(ck.bootstrap_key.baked, ck.keyswitch_key.table_limbs) / 1e6


def step_operations(bk, batch: int):
    """int8 operations of one CMUX step of a baked key at this batch:
    (useful, executed). Useful is the plan's count of block products;
    executed is what the dots kernel runs: every product of the table it
    reads once (ops/blind_rotate.py:dots_tables)."""
    from tfhe_tpu_torch.ops.blind_rotate import dots_tables
    from tfhe_tpu_torch.ops.dots import CHUNK

    k1 = bk.mask_size + 1
    pt = k1 * bk.decomp_length * bk.block
    cols = k1 * 4 * bk.block
    tables = dots_tables(bk.plan, k1, bk.decomp_length, bk.block)
    useful = 2.0 * bk.plan.macs_superblocks * batch * cols * pt
    executed = 2.0 * sum(pr[2] * pr[3] * CHUNK for pr in tables.products) \
        * batch * cols
    return useful, executed


def operations_text(bk, batch, step_s) -> str:
    useful, executed = step_operations(bk, batch)
    return (f"{executed:.4g} int8 operations executed per CMUX step "
            f"({useful:.4g} useful): {executed / step_s / 1e12:.1f} TOP/s "
            f"executed, {useful / step_s / 1e12:.1f} useful, all in")


def phase10_pbs(tp, ks, dev, card):
    from tfhe_tpu_torch import pbs
    from tfhe_tpu_torch.numeric import decode_message
    from tfhe_tpu_torch.ops.blind_rotate import blind_rotate_kernel
    from tfhe_tpu_torch.ops.fused_step import (
        cmux_step_karatsuba,
        cmux_step_karatsuba_plain,
    )
    from tfhe_tpu_torch.polynomial import mul_by_monomial
    from tfhe_tpu_torch.tlwe import tlwe_noiseless_trivial

    fresh_device(dev)
    params = tp.tfhe_parameters_128_pbs()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    t0 = time.perf_counter()
    sk, ck = tp.make_key_pair(gen, params)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk, ksk = ck.bootstrap_key, ck.keyswitch_key
    check(not bk.compact and bk.depth == 2 and bk.polynomial_degree == 512
          and bk.mask_size == 2, "not the baked 128_pbs key")

    space = 4
    msgs = torch.arange(BATCH, device=dev) % space
    lut = torch.tensor([2, 0, 3, 1], device=dev)
    ct = pbs.encrypt_pbs(gen, sk, msgs, space)
    wrappers = reset_counts()
    once = pbs.programmable_bootstrap(bk, ksk, lut, ct, space)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twice = pbs.programmable_bootstrap(bk, ksk, lut, once, space)
    torch.cuda.synchronize()
    lut_s = time.perf_counter() - t0
    correct = int((pbs.decrypt_pbs(sk, twice, space) == lut[lut[msgs]]).sum())
    check(twice.a.shape == (BATCH, params.lwe_size), "PBS output shape")
    check(correct == BATCH, f"PBS f(f(m)): {correct}/{BATCH} correct")

    tables = torch.tensor([[2, 0, 3, 1], [1, 3, 0, 2]], device=dev)
    t0 = time.perf_counter()
    many = pbs.programmable_bootstrap_many(bk, ksk, tables, ct, space, 2)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    got = pbs.decrypt_pbs(sk, many, space)
    check(many.b.shape == (BATCH, 2), "many-LUT output shape")
    many_ok = [int((got[:, r] == tables[r][msgs]).sum()) for r in range(2)]
    check(many_ok == [BATCH, BATCH], f"many-LUT: {many_ok} of {BATCH}")
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(counts == {"blind_rotate": 3, "rotate_decompose_rows": 3 * bk.n},
          f"PBS launches {counts}")
    print(f"[10 PBS] 128_pbs keygen {keygen_s:.2f} s | key {key_mb(ck):.1f} "
          f"MB | LUT [2, 0, 3, 1] twice over {BATCH} messages: second call "
          f"{lut_s:.3f} s = {BATCH / lut_s:.1f} LUTs/s | {correct}/{BATCH} "
          f"equal to f(f(m)) | many-LUT q=2 in {many_s:.3f} s = "
          f"{2 * BATCH / many_s:.1f} LUTs/s, correct {many_ok} | "
          f"{operations_text(bk, BATCH, lut_s / bk.n)} | "
          f"rotation launches {counts} | peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
          flush=True)
    lut_rate = BATCH / lut_s

    # The fused step through its own entry point: the rotation of these
    # ciphertexts and 6 more (a ragged last batch tile), one launch per
    # step on the real key, each step handed over as the card holds it
    # (K-major), held against the whole-rotation kernel (timed on the same
    # key and rows) and against the plain steps.
    rows = torch.arange(BATCH + 6, device=dev) % BATCH
    n_rows = rows.numel()
    w = params.N // space
    bara_t = decode_message(ct.a[rows], 2 * params.N).t().contiguous()
    barb = decode_message(ct.b[rows], 2 * params.N) + w // 2
    testv = pbs.lut_test_polynomial(lut, space, params.N, dev) \
        .expand(n_rows, params.N)
    acc0 = tlwe_noiseless_trivial(mul_by_monomial(testv, -barb),
                                  params.k).a.contiguous()
    kw = dict(l=bk.decomp_length, b=bk.log2_base, t=bk.block, plan=bk.plan,
              balanced=bk.balanced)
    want = blind_rotate_kernel(acc0, bk.baked, bara_t, **kw)
    rotation_ms = cuda_ms(lambda: blind_rotate_kernel(acc0, bk.baked, bara_t,
                                                      **kw), reps=2)
    wrappers = reset_counts()
    torch.cuda.synchronize()
    acc, fused_ms = step_by_step(cmux_step_karatsuba, acc0, bk.baked, bara_t,
                                 kw, relay=False)
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(counts == {"cmux_step_karatsuba": bk.n},
          f"fused-step launches {counts}")
    ks.entries["cmux_step_karatsuba"]["launches"] = \
        counts["cmux_step_karatsuba"]
    check(torch.equal(acc, want),
          "fused steps != whole-rotation kernel on the real 128_pbs key")
    plain, plain_ms = step_by_step(cmux_step_karatsuba_plain, acc0, bk.baked,
                                   bara_t, kw)
    check(torch.equal(acc, plain),
          "fused steps != plain steps on the real 128_pbs key")
    print(f"[10 fused step] cmux_step_karatsuba x {bk.n} steps on {n_rows} "
          f"real ciphertexts, each step's K-major key slice as the card "
          f"holds it: {fused_ms:.3f} ms of step calls, "
          f"{fused_ms / bk.n:.4f} ms per step, against "
          f"blind_rotate_kernel's {rotation_ms / bk.n:.4f} ms per step on "
          f"the same key and rows ({rotation_ms:.3f} ms a rotation; "
          f"x{fused_ms / rotation_ms:.2f}) | equal to blind_rotate_kernel "
          f"and to the plain steps ({plain_ms:.3f} ms, "
          f"{plain_ms / bk.n:.3f} ms per step, each step relaid to the "
          f"reference layout outside its timed span) | launches {counts} | "
          f"{card}", flush=True)
    return lut_rate


RADIX_WORDS = 4096
RADIX_SMALL = 256
MAX_WRONG = 4  # of a batch; a fault gives hundreds


def count_wrong(what, got, want, expected: float, allowed: int = MAX_WRONG):
    wrong = int((got != want).sum())
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    check(wrong <= allowed, f"{what}: {wrong} of {want.numel()} words wrong "
          f"(allowed {allowed})")
    return (f"{what} {wrong} wrong of {want.numel()} "
            f"(model expects {expected:.2g})")


def phase11_radix(tp, dev, card):
    from tfhe_tpu_torch import radix

    fresh_device(dev)
    params = tp.tfhe_parameters_128_radix()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    t0 = time.perf_counter()
    sk, ck = tp.make_key_pair(gen, params)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk = ck.bootstrap_key
    check(not bk.compact and bk.depth == 2 and bk.balanced
          and ck.keyswitch_key.log2_base == 4, "not the baked 128_radix key")
    check(tp.tuning.get_tuning().radix_manylut, "radix_manylut is off")

    bits, fail = 8, 7.9e-5  # the preset's model failure per 8-bit word
    idx = torch.arange(RADIX_WORDS, device=dev)
    av, bv = idx % 251, (idx * 7) % 253
    ca = radix.encrypt_radix(gen, sk, av, bits)
    cb = radix.encrypt_radix(gen, sk, bv, bits)
    wrappers = reset_counts()
    out = radix.radix_add(ck, ca, cb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = radix.radix_add(ck, out, cb)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    # many-LUT: one rotation per digit position, 4 positions, two adds
    check(counts == {"blind_rotate": 2 * bits // 2,
                     "rotate_decompose_rows": 2 * bits // 2 * bk.n},
          f"radix_add launches {counts}")
    check(out.a.shape == (RADIX_WORDS, bits // 2, params.lwe_size),
          "radix_add output shape")
    check(bool(torch.isfinite(out.cv).all()), "non-finite noise variance")
    verdict = count_wrong("radix_add chained twice",
                          radix.decrypt_radix(sk, out),
                          (av + 2 * bv) % 256, 2 * fail * RADIX_WORDS)
    step_s = add_s / (bits // 2) / bk.n
    print(f"[11 radix main path] 128_radix keygen {keygen_s:.2f} s | key "
          f"{key_mb(ck):.1f} MB | radix_add of {RADIX_WORDS} {bits}-bit "
          f"words, second of two chained: {add_s:.3f} s = "
          f"{RADIX_WORDS / add_s:.1f} adds/s, "
          f"{step_s * 1e3:.3f} ms per CMUX step all in | "
          f"{operations_text(bk, RADIX_WORDS, step_s)} | {verdict} | rotation launches {counts} (8 rotations of "
          f"{RADIX_WORDS}) | peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
          flush=True)
    profile_layer("11", f"one radix_add of {RADIX_WORDS} words",
                  lambda: radix.radix_add(ck, ca, cb), add_s * 1e3, card)

    n = RADIX_SMALL
    ca, cb = (first_n(x, n) for x in (ca, cb))
    av, bv = av[:n], bv[:n]

    def dec(word):
        return radix.decrypt_radix(sk, word)

    ops = [
        ("radix_sub", lambda: dec(radix.radix_sub(ck, ca, cb)),
         (av - bv) % 256),
        ("radix_geq", lambda: radix.decrypt_pbs(
            sk, radix.radix_geq(ck, ca, cb), radix.SPACE),
         (av >= bv).to(torch.int32)),
        ("radix_min", lambda: dec(radix.radix_min(ck, ca, cb)),
         torch.minimum(av, bv)),
        ("radix_mul", lambda: dec(radix.radix_mul(ck, ca, cb)),
         (av * bv) % 256),
        ("radix_xor", lambda: dec(radix.radix_xor(ck, ca, cb)), av ^ bv),
        ("radix_shift_left 3",
         lambda: dec(radix.radix_shift_left(ck, ca, 3)), (av << 3) % 256),
        ("radix_neg", lambda: dec(radix.radix_neg(ck, ca)), (-av) % 256),
    ]
    for name, fn, want in ops:
        wrappers = reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        op_s = time.perf_counter() - t0
        rotations = read_counts(wrappers)["blind_rotate"]
        # an upper estimate: every rotation's batch as one more add
        verdict = count_wrong(name, got, want, fail * n * max(rotations, 1))
        print(f"[11 radix ops] {verdict} | {n} words in {op_s:.3f} s | "
              f"{rotations} rotation launches | {card}", flush=True)

    # division at 4-bit words (2 digits): 4 rounds of double, subtract, select
    nv = idx[:n] % 16
    dv = idx[:n] % 5 + 1
    cn = radix.encrypt_radix(gen, sk, nv, 4)
    cd = radix.encrypt_radix(gen, sk, dv, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quo, rem = radix.radix_divide(ck, cn, cd)
    torch.cuda.synchronize()
    div_s = time.perf_counter() - t0
    verdict = count_wrong("radix_divide quotient", dec(quo), nv // dv,
                          fail * n * 8)
    verdict_r = count_wrong("remainder", dec(rem), nv % dv, fail * n * 8)
    print(f"[11 radix ops] {verdict}, {verdict_r} | {n} 4-bit words in "
          f"{div_s:.3f} s | {card}", flush=True)

    # 16-bit words, equality, logical and arithmetic right shifts, and the
    # signed ops (two's complement words), one call each
    a16, b16 = (idx[:n] * 257 + 3) % 65536, (idx[:n] * 8191 + 77) % 65536
    c16 = [radix.encrypt_radix(gen, sk, v, 16) for v in (a16, b16)]
    beq = torch.where(idx[:n] % 2 == 0, av, bv)
    ceq = radix.encrypt_radix(gen, sk, beq, bits)
    sa = (idx[:n] * 37) % 256 - 128
    sb = (idx[:n] * 91 + 5) % 256 - 128
    csa, csb = (radix.encrypt_radix_signed(gen, sk, v, bits) for v in (sa, sb))

    def sdec(word):
        return radix.decrypt_radix_signed(sk, word).to(torch.int64)

    more = [
        ("radix_add 16-bit", lambda: dec(radix.radix_add(ck, *c16)),
         (a16 + b16) % 65536),
        ("radix_eq", lambda: radix.decrypt_pbs(
            sk, radix.radix_eq(ck, ca, ceq), radix.SPACE),
         (av == beq).to(torch.int32)),
        ("radix_shift_right 3",
         lambda: dec(radix.radix_shift_right(ck, ca, 3)), av >> 3),
        ("radix_shift_right_arith 2",
         lambda: sdec(radix.radix_shift_right_arith(ck, csa, 2)), sa >> 2),
        ("radix_abs", lambda: sdec(radix.radix_abs(ck, csa)),
         torch.where(sa == -128, sa, sa.abs())),
        ("radix_geq_signed", lambda: radix.decrypt_pbs(
            sk, radix.radix_geq_signed(ck, csa, csb), radix.SPACE),
         (sa >= sb).to(torch.int32)),
        ("radix_min_signed", lambda: sdec(radix.radix_min_signed(ck, csa,
                                                                 csb)),
         torch.minimum(sa, sb)),
    ]
    for name, fn, want in more:
        wrappers = reset_counts()
        got = fn()
        rotations = read_counts(wrappers)["blind_rotate"]
        verdict = count_wrong(name, got, want, fail * n * max(rotations, 1))
        print(f"[11 radix more] {verdict} | {n} words | {rotations} "
              f"rotation launches | {card}", flush=True)


def first_n(x, n):
    """The first n entries of a sample's leading batch axis."""
    return type(x)(*(f[:n] for f in x))


def phase12_radix_reliable(tp, dev, card):
    from tfhe_tpu_torch import radix

    fresh_device(dev)
    params = tp.tfhe_parameters_128_radix_reliable()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    words, bits = 1024, 8
    with tp.tuning.override(radix_manylut=False, bs_bake_budget=0):
        t0 = time.perf_counter()
        sk, ck = tp.make_key_pair(gen, params)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        bk = ck.bootstrap_key
        check(bk.compact and tuple(bk.baked.shape) == (630, 4, 8, 2, 2048)
              and bk.depth == 2,
              f"unexpected reliable key {tuple(bk.baked.shape)}")
        idx = torch.arange(words, device=dev)
        av, bv = idx % 251, (idx * 7) % 253
        ca = radix.encrypt_radix(gen, sk, av, bits)
        cb = radix.encrypt_radix(gen, sk, bv, bits)
        wrappers = reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = radix.radix_add(ck, ca, cb)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    # stacked tables: one rotation of 2 x words per digit position
    check(counts == {"blind_rotate_compact": bits // 2,
                     "expand_karatsuba_step": bits // 2,
                     "rotate_decompose_rows": bits // 2 * bk.n},
          f"reliable radix_add launches {counts}")
    verdict = count_wrong("radix_add", radix.decrypt_radix(sk, out),
                          (av + bv) % 256, 1.6e-10 * words, allowed=0)
    print(f"[12 radix reliable] 128_radix_reliable compact keygen "
          f"{keygen_s:.2f} s | key {key_mb(ck):.1f} MB | radix_add of "
          f"{words} {bits}-bit words, manylut off (first call): "
          f"{add_s:.3f} s = {words / add_s:.1f} adds/s | {verdict} | "
          f"launches {counts} | peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}",
          flush=True)


def phase13_circuits_netlist(tp, dev, card):
    from tfhe_tpu_torch import circuits, netlist

    fresh_device(dev)
    params = tp.tfhe_parameters_128_fast()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    sk, ck = tp.make_key_pair(gen, params)

    words, bits = 512, 8
    idx = torch.arange(words, device=dev)
    av, bv = idx % 251, (idx * 7) % 253
    ca = circuits.encrypt_word(gen, sk, av, bits)
    cb = circuits.encrypt_word(gen, sk, bv, bits)
    wrappers = reset_counts()
    out = circuits.ripple_carry_add(ck, ca, cb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = circuits.ripple_carry_add(ck, out, cb)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    rotations = read_counts(wrappers)["blind_rotate"]
    # per bit two XORs and a 2-rotation MUX, no MUX after the last bit
    check(rotations == 2 * (4 * bits - 2),
          f"ripple_carry_add: {rotations} rotation launches")
    got = circuits.decrypt_word(sk, out)
    correct = int((got == (av + 2 * bv) % 256).sum())
    check(correct == words, f"ripple_carry_add: {correct}/{words} correct")
    print(f"[13 circuits] ripple_carry_add of {words} {bits}-bit words, "
          f"second of two chained: {add_s:.3f} s = {words / add_s:.1f} "
          f"adds/s | {correct}/{words} correct | {rotations} rotation "
          f"launches in two adds | {card}", flush=True)

    check(netlist._native_lib() is not None,
          "the native scheduler did not build or load")
    bits, batch = 16, 256
    circ = netlist.Circuit()
    a_w, b_w = circ.inputs(bits), circ.inputs(bits)
    sums = netlist.build_kogge_stone_adder(circ, a_w, b_w)
    t0 = time.perf_counter()
    streamed = circ.compile(use_native=True, outputs=sums)
    dense = circ.compile(use_native=True)
    compile_s = time.perf_counter() - t0
    check(streamed.native and streamed.n_slots < circ.n_wires,
          "no slot reuse in the streamed schedule")
    idx = torch.arange(batch, device=dev)
    av, bv = (idx * 257 + 3) % 65536, (idx * 8191 + 77) % 65536
    ca = circuits.encrypt_word(gen, sk, av, bits)
    cb = circuits.encrypt_word(gen, sk, bv, bits)
    inputs = {w: circuits._bit(ca, i) for i, w in enumerate(a_w)}
    inputs.update({w: circuits._bit(cb, i) for i, w in enumerate(b_w)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = streamed.run(ck, inputs, (batch,))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    out = streamed.wire(state, sums)
    check(out.a.shape == (batch, bits, params.lwe_size), "netlist output")
    correct = int((circuits.decrypt_word(sk, out) == (av + bv) % 65536).sum())
    check(correct == batch, f"Kogge-Stone adder: {correct}/{batch} correct")
    dense_out = dense.wire(dense.run(ck, inputs, (batch,)), sums)
    torch.cuda.synchronize()
    check(torch.equal(out.a, dense_out.a) and torch.equal(out.b, dense_out.b),
          "streamed outputs differ from the dense run's")
    n_gates = len(circ.gate_type)
    print(f"[13 netlist] native scheduler loaded (built from "
          f"native/circuit_scheduler.cc) | {bits}-bit Kogge-Stone adder: "
          f"{n_gates} gates, {circ.n_wires} wires in {streamed.n_slots} "
          f"slots, {streamed.n_batches} batches over "
          f"{int(streamed.batch_level.max()) + 1} levels, compiled twice in "
          f"{compile_s * 1e3:.1f} ms | batch {batch}: {run_s:.3f} s = "
          f"{n_gates * batch / run_s:.1f} gates/s | {correct}/{batch} sums "
          f"correct | streamed outputs bit-equal to the dense run's | "
          f"{card}", flush=True)


# Random123's known-answer vectors for threefry2x32 (20 rounds), which
# jax.random reproduces: (key, counter, output).
THREEFRY_KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def timed_s(fn):
    """(result, seconds) of fn() on the host clock, ended by a
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mb(n_bytes) -> float:
    return n_bytes / 1e6


def phase14_wire(tp, dev, card):
    """The wire and serving path at 128_fast, batch 4096, on the card.
    Returns (secret key, cloud key, the inputs and outputs of its NAND
    chain, seconds per layer) for phase 15."""
    from tfhe_tpu_torch import compressed as pc
    from tfhe_tpu_torch import mk, public, rekey, threefry
    from tfhe_tpu_torch.ops.dots import from_kmajor
    from tfhe_tpu_torch.utils import serialization as ser
    from tfhe_tpu_torch.utils import telemetry

    fresh_device(dev)
    params = tp.tfhe_parameters_128_fast()
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    # 4. the threefry twin's known-answer vectors, computed on the card
    for key, (c0, c1), want in THREEFRY_KAT:
        y0, y1 = threefry.threefry2x32(
            key, *(torch.tensor([c], dtype=torch.int64, device=dev)
                   for c in (c0, c1)))
        check(y0.is_cuda and (int(y0), int(y1)) == want,
              f"threefry2x32{key, (c0, c1)} gave {int(y0):#x}, {int(y1):#x}")

    # 1. the client's seeded cloud key, as bytes
    sk = tp.make_secret_key(gen, params)
    seeded, keygen_s = timed_s(lambda: pc.make_seeded_cloud_key(gen, sk))
    wire = ser.dumps(seeded)
    bodies = nbytes(seeded.bootstrap_key.body)
    ks_bodies = nbytes(seeded.keyswitch_key.b)

    # 2. the server loads the bytes onto the card and expands them
    (loaded, ck), expand_s = timed_s(lambda: (
        lambda ld: (ld, pc.expand_cloud_key(ld)))(ser.loads(wire, dev)))
    bk = ck.bootstrap_key
    check(bk.layout == "kmajor"
          and tuple(bk.baked.shape) == (630, 5, 4, T, 3840),
          f"expanded key {tuple(bk.baked.shape)}, layout {bk.layout}")
    print(f"[14 wire] seeded 128_fast cloud key: made in {keygen_s:.2f} s, "
          f"{len(wire)} bytes on the wire (bootstrap bodies "
          f"{mb(bodies):.2f} MB, keyswitch bodies {mb(ks_bodies):.3f} MB) "
          f"against {mb(nbytes(bk.baked, ck.keyswitch_key.table_limbs)):.1f}"
          f" MB expanded (x{nbytes(bk.baked) / len(wire):.0f}) | loads to "
          f"the card + expand_cloud_key: {expand_s:.2f} s, key K-major "
          f"{tuple(bk.baked.shape)} | {card}", flush=True)

    # 3. the masks expanded on the card equal the same seed's on the CPU
    ksk = loaded.keyswitch_key
    shape = (3, ksk.decomp_length, ksk.n_in, ksk.n_out)
    check(torch.equal(
        threefry.uniform_torus32(ksk.seed, shape, dev).cpu(),
        threefry.uniform_torus32(ksk.seed.cpu(), shape, "cpu")),
        "keyswitch masks: card != CPU")
    sb = loaded.bootstrap_key
    step = (1, sb.decomp_length, sb.mask_size + 1, sb.mask_size,
            sb.polynomial_degree)  # step 0 is the first words of the draw
    card_masks = threefry.uniform_torus32(sb.seed, (sb.n,) + step[1:], dev)
    check(torch.equal(card_masks[:1].cpu(),
                      threefry.uniform_torus32(sb.seed.cpu(), step, "cpu")),
          "bootstrap masks of step 0: card != CPU")
    del card_masks
    print(f"[14 wire] threefry on the card: 3 known-answer vectors equal; "
          f"masks card == CPU for the keyswitch key ({shape}) and bootstrap "
          f"step 0 ({step[1:]})", flush=True)

    # 5. untrusted writers encrypt under a seeded public key
    pk_seeded = public.make_public_key_seeded(gen, sk)
    pk_wire = ser.dumps(pk_seeded)
    pk = public.expand_public_key(ser.loads(pk_wire, dev))
    idx = torch.arange(BATCH, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    public.encrypt_public(gen, pk, bits_x[:256])  # warm-up
    ct_x, enc_s = timed_s(lambda: public.encrypt_public(gen, pk, bits_x))
    ct_y = public.encrypt_public(gen, pk, bits_y)
    check(bool((tp.decrypt(sk, ct_x) == bits_x).all()
               and (tp.decrypt(sk, ct_y) == bits_y).all()),
          "public-key ciphertexts do not decrypt")
    wrappers = reset_counts()

    def chain():
        out = tp.gate_nand(ck, ct_x, ct_y)
        for _ in range(LAYERS - 1):
            out = tp.gate_nand(ck, out, ct_y)
        return out

    out, chain_s = timed_s(chain)
    want = ~(bits_x & bits_y)
    for _ in range(LAYERS - 1):
        want = ~(want & bits_y)
    correct = int((tp.decrypt(sk, out) == want).sum())
    check(correct == BATCH, f"public-key NAND chain: {correct}/{BATCH}")

    # 6. the results travel back mod-switched to 16 bits
    full_wire = len(ser.dumps(out))
    small_wire = ser.dumps(pc.compress_lwe(out, bits=16))
    back = pc.decompress_lwe(ser.loads(small_wire, dev))
    back_ok = int((tp.decrypt(sk, back) == want).sum())
    check(back_ok == BATCH, f"16-bit results: {back_ok}/{BATCH} decrypt")

    # 7. the noise report of the outputs
    report = telemetry.noise_margin(sk, out, want)
    check(report.healthy(), f"noise margin unhealthy: {report}")

    # 8. re-keying the results to a second user
    sk2 = tp.make_secret_key(gen, params)
    rk = rekey.make_rekey_key(gen, sk, sk2)
    rekey.rekey(rk, ct_x)  # warm-up
    moved, rekey_s = timed_s(lambda: rekey.rekey(rk, out))
    moved_ok = int((tp.decrypt(sk2, moved) == want).sum())
    check(moved_ok == BATCH, f"re-keyed: {moved_ok}/{BATCH} decrypt")
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(counts.get("blind_rotate") == LAYERS,
          f"the wire path's NAND layers launched {counts}")
    print(f"[14 serving] seeded public key ({public.default_count(params)} "
          f"zero encryptions): {len(pk_wire)} bytes on the wire against "
          f"{mb(nbytes(pk.zeros.a, pk.zeros.b, pk.zeros.cv)):.1f} MB "
          f"expanded | encrypt_public of {BATCH} bits {enc_s * 1e3:.3f} ms | "
          f"{LAYERS} NAND layers on them in {chain_s:.3f} s = "
          f"{BATCH * LAYERS / chain_s:.1f} gates/s, {correct}/{BATCH} "
          f"correct | launches {counts} | 16-bit results: {len(small_wire)} "
          f"bytes against {full_wire}, {back_ok}/{BATCH} decrypt | noise: "
          f"max error {report.max_error:.3e}, margin {report.margin:.4f}, "
          f"healthy | rekey to a second user {rekey_s * 1e3:.3f} ms, "
          f"{moved_ok}/{BATCH} correct under the second key | {card}",
          flush=True)

    # 9. a 2-party lownoise ceremony through the seeded wire forms
    mk_params = mk.mktfhe_parameters_2party_lownoise()
    shared_wire = ser.dumps(pc.make_shared_key_seeded(gen, mk_params))
    shared = pc.expand_shared_key(ser.loads(shared_wire, dev))
    mk_sks, parts, part_wires, part_full = [], [], [], []
    for _ in range(2):
        mk_sks.append(tp.make_secret_key(gen, mk_params))
        data = ser.dumps(pc.make_seeded_cloud_key_part(gen, mk_sks[-1],
                                                       shared))
        part_wires.append(len(data))
        parts.append(pc.expand_cloud_key_part(ser.loads(data, dev)))
        part_full.append(nbytes(parts[-1].public_key,
                                parts[-1].key_uni_enc.cd,
                                parts[-1].keyswitch_key.table_limbs))
    mk_ck = mk.make_mk_cloud_key(parts)
    del parts
    wrappers = reset_counts()
    _, _, mk_correct, mk_s = mk_nand_chain(mk, mk_ck, mk_sks, gen, 1, BATCH,
                                           dev)
    mk_counts = {k: v for k, v in read_counts(wrappers).items() if v}
    check(mk_counts.get("mk_blind_rotate_compact") == 2,
          f"the seeded MK layer launched {mk_counts}")
    print(f"[14 MK wire] 2-party lownoise seeded ceremony: shared key "
          f"{len(shared_wire)} bytes; per party {part_wires} bytes on the "
          f"wire against {[round(mb(x), 1) for x in part_full]} MB expanded"
          f" | one MK NAND layer of {BATCH} on the assembled key: "
          f"{mk_s:.3f} s = {BATCH / mk_s:.1f} gates/s, {mk_correct}/{BATCH} "
          f"correct | launches {mk_counts} | {card}", flush=True)
    del mk_ck

    # 10. a baked card key through the file format and back
    toy_sk, toy_ck = tp.make_key_pair(gen, tp.tfhe_parameters_toy())
    held = toy_ck.bootstrap_key.baked
    check(toy_ck.bootstrap_key.layout == "kmajor", "toy key not K-major")
    data = ser.dumps(toy_ck)
    on_cpu = ser.loads(data, "cpu")
    ref_layout = torch.stack([from_kmajor(s) for s in held]).cpu()
    check(on_cpu.bootstrap_key.layout == "reference"
          and torch.equal(on_cpu.bootstrap_key.baked, ref_layout),
          "a card key loaded on the CPU is not from_kmajor of the card key")
    again = ser.loads(ser.dumps(on_cpu), dev)
    check(again.bootstrap_key.layout == "kmajor"
          and torch.equal(again.bootstrap_key.baked, held)
          and torch.equal(again.keyswitch_key.table_limbs,
                          toy_ck.keyswitch_key.table_limbs),
          "the card key did not survive the round trip")
    print(f"[14 file format] toy baked key ({mb(nbytes(held)):.1f} MB, "
          f"K-major on the card): dumps -> loads on the CPU = from_kmajor "
          f"of the card key; -> loads on the card = the card key | {card}",
          flush=True)
    return sk, ck, (ct_x, ct_y), chain_s / LAYERS


def phase15_jobs_debug_profiling(tp, ks, dev, card, wire):
    """Checkpointed jobs, debug mode and profiling on phase 14's key."""
    import os
    import shutil
    import tempfile

    from tfhe_tpu_torch import circuits, debug, netlist
    from tfhe_tpu_torch.ops import blind_rotate as br
    from tfhe_tpu_torch.utils import jobs, profiling

    sk, ck, (ct_x, ct_y), layer_s = wire
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    # 1. a 16-bit Kogge-Stone job, preempted after its first chunk
    bits, batch = 16, 256
    circ = netlist.Circuit()
    a_w, b_w = circ.inputs(bits), circ.inputs(bits)
    sums = netlist.build_kogge_stone_adder(circ, a_w, b_w)
    sched = circ.compile(use_native=True, outputs=sums)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    idx = torch.arange(batch, device=dev)
    av, bv = (idx * 257 + 3) % 65536, (idx * 8191 + 77) % 65536
    ca = circuits.encrypt_word(gen, sk, av, bits)
    cb = circuits.encrypt_word(gen, sk, bv, bits)
    inputs = {w: circuits._bit(ca, i) for i, w in enumerate(a_w)}
    inputs.update({w: circuits._bit(cb, i) for i, w in enumerate(b_w)})
    want, whole_s = timed_s(lambda: sched.run(ck, inputs, (batch,)))
    path = os.path.join(tmp, "job.ckpt")

    class Preempted(Exception):
        pass

    def preempt(done, total):
        raise Preempted(done)

    try:
        jobs.run_checkpointed(sched, ck, inputs, path, batch_shape=(batch,),
                              every=2, on_chunk=preempt)
        check(False, "the job was not preempted")
    except Preempted:
        pass
    ckpt_bytes = os.path.getsize(path)
    resumed_at = []
    got, resume_s = timed_s(lambda: jobs.run_checkpointed(
        sched, ck, inputs, path, batch_shape=(batch,), every=2,
        on_chunk=lambda done, total: resumed_at.append(done)))
    check(resumed_at[0] == 4, f"the job resumed at batch {resumed_at[:1]}")
    check(torch.equal(got.a, want.a) and torch.equal(got.b, want.b),
          "the resumed job differs from the uninterrupted run")
    check(not os.path.exists(path), "the checkpoint was left behind")
    sums_ok = int((circuits.decrypt_word(sk, sched.wire(got, sums))
                   == (av + bv) % 65536).sum())
    check(sums_ok == batch, f"checkpointed adder: {sums_ok}/{batch}")
    print(f"[15 jobs] 16-bit Kogge-Stone at batch {batch}, "
          f"{sched.n_batches} scheduled batches, a checkpoint every 2: "
          f"preempted after the first chunk ({ckpt_bytes} bytes of "
          f"checkpoint), resumed at batch 2, finished in {resume_s:.3f} s "
          f"(uninterrupted {whole_s:.3f} s), bit-equal, checkpoint removed, "
          f"{sums_ok}/{batch} sums correct | {card}", flush=True)

    # 2. one NAND layer under debug mode: clean, the same words
    plain_out = tp.gate_nand(ck, ct_x, ct_y)
    with tp.tuning.override(debug=True):
        dbg_out, dbg_s = timed_s(lambda: tp.gate_nand(ck, ct_x, ct_y))
    check(torch.equal(dbg_out.a, plain_out.a)
          and torch.equal(dbg_out.b, plain_out.b),
          "the debug layer's words differ from the layer without debug")

    # 3. the same with the kernel wrapper's output corrupted
    real = br.blind_rotate_kernel

    def corrupted(*args, **kw):
        out = real(*args, **kw)
        out[0, 0, 0] += 1
        return out

    br.blind_rotate_kernel = corrupted
    try:
        with tp.tuning.override(debug=True):
            tp.gate_nand(ck, ct_x, ct_y)
        raised = False
    except debug.FHEDebugError:
        raised = True
    finally:
        br.blind_rotate_kernel = real
    check(raised, "debug mode did not raise on a corrupted kernel output")
    print(f"[15 debug] one NAND layer of {BATCH} under debug: "
          f"{dbg_s:.3f} s (without: {layer_s:.3f} s), the kernel held "
          f"against the step-by-step loop, outputs equal to the layer "
          f"without debug | with the kernel's output corrupted: "
          f"FHEDebugError | {card}", flush=True)

    # 4. a trace of one layer
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir):
        tp.gate_nand(ck, ct_x, ct_y)
        torch.cuda.synchronize()
    trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    check(trace_bytes > 0, "the trace is empty")

    # 5. the roofline of the layer's rotation
    roof = profiling.bootstrap_roofline(ck.params, BATCH, depth=1)
    util = roof.utilization(layer_s)
    per_step_ms = roof.int8_floor_s / ck.params.lwe_size * 1e3
    row1 = ks.entries["blind_rotate"]
    row1_step_ms = row1["bound_ms"] / TIMED_STEPS
    check(row1["bound_by"] == "operations"
          and abs(per_step_ms - row1_step_ms) <= 0.01 * row1_step_ms,
          f"roofline {per_step_ms:.5f} ms a step against phase 3's row-1 "
          f"bound {row1_step_ms:.5f}")
    print(f"[15 profiling] trace of one layer: {trace_bytes} bytes of "
          f"Chrome trace | bootstrap_roofline(128_fast, {BATCH}, depth=1): "
          f"{roof.byte_macs:.4g} int8 MACs, {mb(roof.hbm_bytes):.1f} MB, "
          f"floors {roof.int8_floor_s * 1e3:.3f} ms (int8) and "
          f"{roof.hbm_floor_s * 1e3:.3f} ms (HBM) a layer, {per_step_ms:.5f}"
          f" ms a step against phase 3's row-1 bound {row1_step_ms:.5f} | "
          f"the measured layer ({layer_s * 1e3:.1f} ms) at "
          f"{100 * util['int8']:.1f}% of the int8 floor | {card}",
          flush=True)
    shutil.rmtree(tmp)


def phase16_multi_device(tp, dev, card, phase4_rate):
    """The sharded paths over several ranks of `parallel/dryrun.py`."""
    import os
    import tempfile

    from tfhe_tpu_torch import compressed as pc
    from tfhe_tpu_torch import mk, radix
    from tfhe_tpu_torch.parallel import dryrun
    from tfhe_tpu_torch.utils import serialization as ser

    fresh_device(dev)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    idx = torch.arange(BATCH, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke16_") as tmp:
        files = {}

        def save(name, obj):
            files[name] = os.path.join(tmp, name + ".bin")
            ser.save(obj, files[name])

        def seeded_key(name, params):
            sk = tp.make_secret_key(gen, params)
            save(name, pc.make_seeded_cloud_key(gen, sk))
            save(name + "_sk", sk)
            return sk

        for name, params in (("fast", tp.tfhe_parameters_128_fast()),
                             ("fast8", tp.tfhe_parameters_128_fast8())):
            sk = seeded_key(name, params)
            save(name + "_x", tp.encrypt(gen, sk, idx % 2 == 0))
            save(name + "_y", tp.encrypt(gen, sk, idx % 3 == 0))
        sk = seeded_key("radix", tp.tfhe_parameters_128_radix())
        words = torch.randint(0, 256, (2, BATCH), device=dev, generator=gen)
        save("radix_x", radix.encrypt_radix(gen, sk, words[0], 8))
        save("radix_y", radix.encrypt_radix(gen, sk, words[1], 8))
        mk_params = mk.mktfhe_parameters_2party_lownoise()
        shared = pc.expand_shared_key(pc.make_shared_key_seeded(gen,
                                                                mk_params))
        mk_sks = tuple(tp.make_secret_key(gen, mk_params) for _ in range(2))
        mk_ck = mk.make_mk_cloud_key([
            pc.expand_cloud_key_part(pc.make_seeded_cloud_key_part(
                gen, s, shared)) for s in mk_sks])
        save("mk", mk_ck)
        save("mk_sk", mk_sks)
        save("mk_x", mk.mk_encrypt(gen, mk_sks, idx % 2 == 0))
        save("mk_y", mk.mk_encrypt(gen, mk_sks, idx % 3 == 0))
        del mk_ck, shared, sk, words
        fresh_device(dev)  # the ranks share the card: free this process's keys
        files_s = time.perf_counter() - t_phase

        def case(kind, name, mesh, key, **kw):
            out = dict(kind=kind, name=name, mesh=list(mesh),
                       key=files[key], secret=files[key + "_sk"], **kw)
            for f in ("x", "y"):
                out.setdefault(f, files[f"{key}_{f}"])
            return out

        worlds = [
            (1, "nccl", [case("nand", "(a) 128_fast NAND", (1, 1), "fast",
                              repeat=5)]),
            (2, "gloo", [
                case("mk_nand", "(b) 2-party MK NAND", (1, 2), "mk"),
                case("rotate", "(c) 128_fast rotation", (1, 2), "fast",
                     batch=ROTATE_BATCH)]),
            (4, "gloo", [
                case("nand", "(b) 128_fast NAND", (2, 2), "fast"),
                case("nand", "(b) 128_fast8 compact NAND", (2, 2), "fast8",
                     tuning={"bs_bake_budget": 0}),
                case("radix_add", "(b) 128_radix add", (4, 1), "radix"),
                case("rotate", "(c) 128_fast rotation", (2, 2), "fast",
                     batch=ROTATE_BATCH)]),
        ]
        kernel = {"nand": "blind_rotate", "radix_add": "blind_rotate",
                  "mk_nand": "mk_blind_rotate_compact"}
        for world, backend, plan in worlds:
            plan_path = os.path.join(tmp, f"plan{world}.json")
            with open(plan_path, "w") as f:
                json.dump(plan, f)
            t0 = time.perf_counter()
            try:
                ranks = dryrun.launch(["--device", "cuda", "--backend",
                                       backend, "--plan", plan_path], world,
                                      DRYRUN_TIMEOUT_S)
            except RuntimeError as e:
                check(False, f"phase 16, {world} ranks: {e}")
            world_s = time.perf_counter() - t0
            ranks.sort(key=lambda r: r["rank"])
            for c in plan:
                res = [next(x for x in r["results"] if x["name"] == c["name"])
                       for r in ranks]
                head = res[0]
                where = f"{c['name']} at mesh {tuple(c['mesh'])}"
                if c["kind"] == "rotate":
                    check(all(r["equal"] for r in res),
                          f"{where}: a rank's rows != blind_rotate")
                    check(all("blind_rotate" in r["reference_launches"]
                              and not r["launches"] for r in res),
                          f"{where}: launches {[r['launches'] for r in res]}"
                          f", unsharded {[r['reference_launches'] for r in res]}")
                else:
                    check(head["equal"], f"{where}: != the unsharded output")
                    want = ("blind_rotate_compact" if "tuning" in c
                            else kernel[c["kind"]])
                    check(all(want in r["launches"] for r in res),
                          f"{where}: launches {[r['launches'] for r in res]}")
                allowed = MAX_WRONG if c["kind"] == "radix_add" else 0
                check(head["correct"] >= head["of"] - allowed,
                      f"{where}: {head['correct']}/{head['of']} correct")
                per_rank = " ; ".join(
                    f"rank {i}: launches {r['launches']}"
                    + (f" (unsharded {r['reference_launches']})"
                       if c["kind"] == "rotate" else "")
                    + f", {r['collectives']} collectives, "
                    f"{mb(r['staged_bytes']):.1f} MB staged, peak "
                    f"{r['peak_bytes'] / 1e9:.2f} GB" for i, r in enumerate(res))
                line = (f"[16 multi-device] {where}, {world} rank(s) over "
                        f"{backend}: bit-equal to the unsharded port, "
                        f"{head['correct']}/{head['of']} correct | sharded "
                        f"call {head['seconds']:.3f} s on rank 0")
                if c["kind"] == "nand" and world == 1:
                    line += (f" = {head['of'] / head['seconds']:.1f} gates/s"
                             f" (the fastest of {c['repeat']}), unsharded "
                             f"gate_nand in the same rank, in turns "
                             f"{head['of'] / head['unsharded_seconds']:.1f} "
                             f"gates/s, phase 4 {phase4_rate:.1f} gates/s")
                if c["kind"] in ("rotate", "mk_nand"):
                    line += (" | key bytes a rank "
                             + ", ".join(f"{r['key_bytes'] / 1e9:.3f}"
                                         for r in res)
                             + f" GB of {head['full_key_bytes'] / 1e9:.3f} GB")
                    check(all(r["key_bytes"] * c["mesh"][1]
                              == r["full_key_bytes"] for r in res),
                          f"{where}: key bytes not 1/model of the key")
                if c["kind"] == "rotate":
                    line += (f" | unsharded rotation of the rank's rows "
                             f"{head['reference_seconds']:.3f} s")
                print(line + f" | {per_rank} | {card}", flush=True)
            print(f"[16 multi-device] {world} rank(s): {world_s:.1f} s "
                  f"with start-up | {card}", flush=True)
    print(f"[16 multi-device] phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s (keys and inputs written "
          f"in {files_s:.1f} s) | {card}", flush=True)


ROTATE_BATCH = 1024  # 630 host-staged all-reduces a rotation
DRYRUN_TIMEOUT_S = 300


# --- phase 17: the entry points on the card ---

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "params",
              "security_core_svp_bits", "correct", "of"}
# The rotation kernel each bench preset's key form runs: the compact key
# for 128fast8, the baked (Karatsuba) key for the others.
BENCH_PRESETS = {"128fast": "blind_rotate", "128fast8": "blind_rotate_compact",
                 "128": "blind_rotate", "80": "blind_rotate"}
BENCH_AGREE = 0.05  # the 128fast line against phase 4: the same 5 layers
SECTION_TIMEOUT_S = 240  # TFHE_SUITE_SECTION_TIMEOUT_S: a bound per section
ENTRY_TIMEOUT_S = 600  # one example, sweep or bench process
TAIL = 1e-6  # the chance a correct port exceeds a model-derived error limit
# Model failure rates of the suite's error-counted lines: the 128 preset's
# radix add ~3.8e-3 a word an add (tfhe_tpu/params.py:237,
# docs/leveled_mode.md 2b); the reference-fidelity 2-party MK preset ~1.5%
# a gate (tfhe_tpu/mk/api.py:41, docs/mk_noise_budget.md) and the 4-party
# preset ~0.02% a gate (sigma_rot 0.034 against the 0.125 margin,
# docs/mk_noise_budget.md:97); the 8-party and 2-party lownoise presets
# ~0 (0 errors allowed). Each line's output went through two chained adds
# or gates: a word or gate is wrong if either failed.
MODEL_FAIL = {
    "radix_adder8_words_per_sec": (3.8e-3, "3.8e-3 a word an add"),
    "mk2_nand_throughput_reference_preset": (0.015, "~1.5% a gate"),
    "mk4_nand_throughput": (2e-4, "~0.02% a gate"),
}
# The suite's lines, section by section (bench_suite.py's metric names).
SUITE_METRICS = (
    "single_nand_latency_80bit", "chained_nand_device_latency_80bit",
    "single_nand_latency_compact_key", "gate_set_correct",
    "batched_nand_throughput_128bit", "pbs_lut4_throughput_128bit",
    "adder8_words_per_sec", "radix_adder8_words_per_sec",
    "batched_nand_throughput_128fast", "batched_nand_throughput_128fast8",
    "radix_adder8_words_per_sec_radix_preset",
    "radix_adder8_words_per_sec_reliable", "mk2_nand_throughput",
    "mk2_nand_throughput_reference_preset", "mk4_nand_throughput",
    "mk8_nand_throughput")
# The rotation kernel each suite section's key form runs (rows 1, 6, 8).
SUITE_KERNELS = {
    "80bit": ("blind_rotate", "blind_rotate_compact"),
    "128core": ("blind_rotate",), "fast": ("blind_rotate",),
    "fast8": ("blind_rotate_compact",), "radix_preset": ("blind_rotate",),
    "radix_reliable": ("blind_rotate_compact",),
    "mk2": ("mk_blind_rotate_compact",),
    "mk2_ref": ("mk_blind_rotate_compact",),
    "mk4": ("mk_blind_rotate_compact",),
    "mk8": ("mk_blind_rotate_compact",)}
FORM_KERNEL = {"baked": "blind_rotate", "compact": "blind_rotate_compact"}
SWEEP_PRESETS = "128fast,128fast8,80"
SWEEP_FORMS = {"128fast": ("baked", "compact"), "128fast8": ("compact",),
               "80": ("baked", "compact")}
SWEEP_BATCHES = (1, 8, 64, 512, 4096)
CHAIN_LAYERS = 2 * 8 * len(SWEEP_BATCHES)  # a warm-up and a timed chain
EXAMPLES = ("multitenant", "tutorial", "pbs_lut", "radix_arithmetic",
            "multikey", "wire_format")


def binomial_limit(n: int, p: float, tail: float = TAIL) -> int:
    """The least k with P(X > k) < tail for X ~ Binomial(n, p)."""
    import math

    log_q = math.log1p(-p)
    cdf, k = 0.0, 0
    while True:
        cdf += math.exp(math.lgamma(n + 1) - math.lgamma(k + 1)
                        - math.lgamma(n - k + 1) + k * math.log(p)
                        + (n - k) * log_q)
        if 1.0 - cdf < tail:
            return k
        k += 1


def start_entry(module: str, *args, env=None):
    """Start `python -m tfhe_tpu_torch.<module> args` on the card, in a
    session of its own (so that a kill reaches the whole group: the
    suite's sections too); `finish_entry` waits for it."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p), **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"tfhe_tpu_torch.{module}", *args], cwd=root,
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    return SimpleNamespace(proc=proc, t0=t0,
                           what=" ".join((module,) + args))


def kill_entry(run):
    import os
    import signal

    if run.proc.poll() is None:
        os.killpg(run.proc.pid, signal.SIGKILL)
        run.proc.communicate()


def finish_entry(run, timeout=ENTRY_TIMEOUT_S):
    """Wait for a started entry point, at most `timeout` seconds from its
    start (then its group is killed and the run fails). Returns (exit
    code, stdout, stderr, seconds)."""
    left = timeout - (time.perf_counter() - run.t0)
    try:
        out, err = run.proc.communicate(timeout=max(left, 0.1))
    except subprocess.TimeoutExpired:
        kill_entry(run)
        check(False, f"{run.what} passed its {timeout} s limit")
    return run.proc.returncode, out, err, time.perf_counter() - run.t0


def run_entry(module: str, *args, env=None, timeout=ENTRY_TIMEOUT_S):
    """`start_entry` and `finish_entry`: (exit code, stdout, stderr,
    seconds)."""
    return finish_entry(start_entry(module, *args, env=env), timeout)


def entry_ok(what, rc, out, err, want_rc=0):
    check(rc == want_rc, f"{what} exited {rc} (expected "
                         f"{want_rc})\n--- stdout\n{out[-3000:]}\n--- "
                         f"stderr\n{err[-3000:]}")


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def logged_launches(err: str, tag: str) -> dict:
    """The launch counts an entry point logged as "<tag> kernel launches:
    {...}"."""
    import ast

    line = next((ln for ln in err.splitlines()
                 if ln.startswith(f"{tag} kernel launches: ")), None)
    check(line is not None, f"no kernel launches logged for {tag}")
    return ast.literal_eval(line.split(": ", 1)[1])


def phase17_bench(card, phase4_rate):
    """Each preset's bench line."""
    for which, kernel in BENCH_PRESETS.items():
        rc, out, err, secs = run_entry(
            "bench", env={"TFHE_TPU_BENCH_PARAMS": which})
        entry_ok(f"bench {which}", rc, out, err)
        rec = json.loads(out.strip().splitlines()[-1])
        check(set(rec) == BENCH_KEYS, f"bench {which}: keys {sorted(rec)}")
        check(rec["params"] == which and rec["correct"] == rec["of"] == BATCH,
              f"bench {which}: {rec['correct']}/{rec['of']} correct")
        launched = next(ln for ln in err.splitlines()
                        if ln.startswith("kernel launches in the timed"))
        check(f"'{kernel}': {LAYERS}" in launched,
              f"bench {which}: {launched}")
        built = next(ln for ln in err.splitlines()
                     if ln.startswith("builds through the first call"))
        line = (f"[17 entry points] bench {which}: {rec['value']} gates/s, "
                f"{rec['correct']}/{rec['of']} correct, "
                f"{rec['security_core_svp_bits']} bits, vs_baseline "
                f"{rec['vs_baseline']} | {launched} | {built} | "
                f"{secs:.1f} s")
        if which == "128fast":
            off = rec["value"] / phase4_rate - 1
            check(abs(off) <= BENCH_AGREE,
                  f"bench 128fast {rec['value']} gates/s against phase 4's "
                  f"{phase4_rate:.1f}: {100 * off:+.1f}%")
            line += (f" | phase 4 {phase4_rate:.1f} gates/s, "
                     f"{100 * off:+.1f}% (limit {100 * BENCH_AGREE:.0f}%)")
        print(f"{line} | {card}", flush=True)


def suite_limit(rec: dict):
    """(wrong, most wrong allowed, the limit's source) of a suite line."""
    name, n = rec["metric"], rec.get("of", rec.get("batch"))
    if name == "gate_set_correct":
        return 10 - rec["value"], 0, "10/10 gates"
    wrong = rec["errors"] if "errors" in rec else rec["of"] - rec["correct"]
    if name in MODEL_FAIL:
        rate, what = MODEL_FAIL[name]
        return (wrong, binomial_limit(n, 1 - (1 - rate)**2),
                f"{what}, two in a chain, tail {TAIL:g}")
    if name == "radix_adder8_words_per_sec_radix_preset":
        return wrong, MAX_WRONG, "as phase 11"
    return wrong, 0, "every output correct"


def phase17_suite(card):
    from tfhe_tpu_torch import bench_suite

    rc, out, err, secs = run_entry(
        "bench_suite", timeout=SECTION_TIMEOUT_S * len(bench_suite.SECTIONS),
        env={"TFHE_SUITE_SECTION_TIMEOUT_S": str(SECTION_TIMEOUT_S)})
    recs = json_lines(out)
    failed = [r["metric"] for r in recs if r["metric"].startswith("section_")]
    check(not failed, f"bench_suite: failed sections {failed}\n"
                      f"{err[-3000:]}")
    entry_ok("bench_suite", rc, out, err)
    check(tuple(r["metric"] for r in recs) == SUITE_METRICS
          and not any(r.get("small_toy_params") for r in recs),
          f"bench_suite lines {[r['metric'] for r in recs]}")
    for r in recs:
        wrong, most, why = suite_limit(r)
        limit = f"at most {most} wrong ({why})"
        check(wrong <= most, f"bench_suite {r['metric']}: {r} breaks its "
                             f"limit: {limit}")
        print(f"[17 entry points] suite {json.dumps(r)} | limit: {limit} | "
              f"{card}", flush=True)
    for name, kernels in SUITE_KERNELS.items():
        counts = logged_launches(err, f"[suite] {name}")
        check(all(counts.get(k, 0) > 0 for k in kernels),
              f"bench_suite {name}: launches {counts}, expected {kernels}")
        took = next(ln for ln in err.splitlines()
                    if ln.startswith(f"[suite] section {name}:"))
        print(f"[17 entry points] suite section {name}: "
              f"{took.split('(')[-1].rstrip(')')}, launches {counts} | "
              f"{card}", flush=True)
    print(f"[17 entry points] bench_suite: {len(recs)} lines, every section "
          f"exit 0 (limit {SECTION_TIMEOUT_S} s each) | {secs:.1f} s | "
          f"{card}", flush=True)


def phase17_sweep(card):
    """The sweep's lines."""
    rc, out, err, secs = run_entry(
        "tools.serving_bench", timeout=2 * ENTRY_TIMEOUT_S,
        env={"TFHE_TPU_SERVE_PRESETS": SWEEP_PRESETS})
    entry_ok("serving_bench", rc, out, err)
    recs = json_lines(out)
    want = [(p, f, b) for p in SWEEP_PRESETS.split(",")
            for f in SWEEP_FORMS[p] for b in SWEEP_BATCHES]
    got = [(r["preset"], r["form"], r["batch"]) for r in recs]
    check(got == want, f"serving_bench lines {got}")
    for r in recs:
        check(r["correct"] == r["of"], f"serving_bench {r}")
    for p, f in dict.fromkeys((p, f) for p, f, _ in want):
        rows = [r for r in recs if (r["preset"], r["form"]) == (p, f)]
        counts = logged_launches(err, f"{p}/{f}")
        check(counts.get(FORM_KERNEL[f], 0) == CHAIN_LAYERS,
              f"serving_bench {p}/{f}: launches {counts}")
        print(f"[17 entry points] sweep {p} {f}, key {rows[0]['key_mb']} MiB"
              f", launches {counts} | " + " | ".join(
                  f"batch {r['batch']}: {r['ms_per_layer']} ms a layer, "
                  f"{r['gates_per_sec']} gates/s, {r['correct']}/{r['of']}"
                  for r in rows) + f" | {card}", flush=True)
    print(f"[17 entry points] serving_bench: {len(recs)} lines, all correct "
          f"| {secs:.1f} s | {card}", flush=True)


def phase17_examples(card):
    import os
    import tempfile

    for name in EXAMPLES:
        rc, out, err, secs = run_entry(f"examples.{name}", "--production")
        entry_ok(f"example {name}", rc, out, err)
        shown = " / ".join(ln for ln in out.strip().splitlines()
                           if not ln.startswith("Trial"))
        print(f"[17 entry points] example {name} --production: "
              f"{shown[-400:]} | {secs:.1f} s | {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke17_") as tmp:
        ckpt = os.path.join(tmp, "job.ckpt")
        argv = ("--params", "80", "--preempt-after", "1", "--ckpt", ckpt)
        rc, out, err, secs = run_entry("tools.batch_job", *argv)
        entry_ok("batch_job, first run", rc, out, err, want_rc=17)
        check("simulated preemption" in out and os.path.exists(ckpt),
              f"batch_job: no preemption or no checkpoint:\n{out}")
        first = out.strip().splitlines()
        rc, out, err, secs2 = run_entry("tools.batch_job", *argv)
        entry_ok("batch_job, second run", rc, out, err)
        lines = out.strip().splitlines()
        check(lines[0].startswith("resuming at batch")
              and lines[-1].endswith(": 64/64 sums correct")
              and not os.path.exists(ckpt),
              f"batch_job: the second run did not resume and finish:\n{out}")
        print(f"[17 entry points] batch_job --params 80 --preempt-after 1: "
              f"{first[-2]}, exit 17 ({secs:.1f} s); again: {lines[0]}, "
              f"{lines[-1]} ({secs2:.1f} s) | {card}", flush=True)


def phase17_entry_points(dev, card, phase4_rate):
    """Each entry point of the port as a subprocess on the card."""
    fresh_device(dev)  # the entry points share the card with this process
    t_phase = time.perf_counter()
    phase17_bench(card, phase4_rate)
    phase17_suite(card)
    phase17_sweep(card)
    phase17_examples(card)
    print(f"[17 entry points] phase 17 took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)


# --- phase 18: the last entry-point twins ---

PBS_AGREE = 0.05  # pbs_bench against phase 10: the same timed call
# The profile runs (PROFILE_PARAMS, batch): the reference's default, and
# the 80-bit preset at the batches whose layers cost the same (section 6).
PROFILE_RUNS = (("128", BATCH), ("80", 1), ("80", 8), ("80", 64))
ROTATION_KERNELS = ("rotate_decompose_kernel", "leaf_dots_kernel")
SCALING_BATCH = 64  # scaling_bench's default per-device batch


def phase18_entry(dev, card, real_key):
    """(a) entry() in this process: the fake key against phase 4's real
    one, one rotation launch, the words a zero key gives."""
    from tfhe_tpu_torch import graft_entry, instrument
    from tfhe_tpu_torch.lwe import lwe_noiseless_trivial
    from tfhe_tpu_torch.numeric import decode_message, encode_message
    from tfhe_tpu_torch.ops import launches, reset_launches
    from tfhe_tpu_torch.polynomial import mul_by_monomial
    from tfhe_tpu_torch.tlwe import (tlwe_extract_sample,
                                     tlwe_noiseless_trivial)

    fresh_device(dev)
    t0 = time.perf_counter()
    fn, (ck, x, y) = graft_entry.entry()
    bk, ksk = ck.bootstrap_key, ck.keyswitch_key
    fake = {"baked": tuple(bk.baked.shape), "depth": bk.depth,
            "layout": bk.layout,
            "keyswitch": tuple(ksk.table_limbs.shape)}
    check(fake == real_key and bk.layout == "kmajor",
          f"entry()'s fake key {fake} against phase 4's real key {real_key}")
    wrappers = reset_launches()
    out = fn(ck, x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches(wrappers)
    check(instrument.counts(wrappers) == {"blind_rotate": 1,
                                          "rotate_decompose_rows": bk.n}
          and counts.get("path.baked") == 1,
          f"entry(): launches {counts}")
    # A zero key leaves the accumulator as it starts: the trivial one after
    # the mod switch; its extraction, keyswitched by a zero key, is the
    # output (a zero, b the extraction's b).
    params, batch = ck.params, x.b.shape[0]
    mu = encode_message(1, 8)
    res = lwe_noiseless_trivial(mu, params.lwe_size, (batch,), dev) - x - y
    barb = decode_message(res.b, 2 * params.N)
    testv = torch.full((batch, params.N), mu, dtype=torch.int32, device=dev)
    want = tlwe_extract_sample(tlwe_noiseless_trivial(
        mul_by_monomial(testv, -barb), params.k))
    check(not out.a.any() and torch.equal(out.b, want.b),
          "entry(): the words differ from a zero key's")
    print(f"[18 twins] (a) entry(): 128_fast at batch {batch} (ragged rows), "
          f"fake key K-major {fake['baked']} depth {fake['depth']}, keyswitch "
          f"limbs {fake['keyswitch']}: phase 4's real key's shapes | "
          f"launches {counts} | a all zero, b equal word for word to the "
          f"trivial accumulator's extraction | {secs:.2f} s with the "
          f"{nbytes(bk.baked) / 1e9:.2f} GB of zeros | {card}", flush=True)
    del fn, ck, bk, ksk, x, y, out
    fresh_device(dev)


def phase18_beside(card):
    """(b) and (e), together (checks of the paths: their rates are read
    under each other's load): the reference's __main__ as a subprocess
    (dryrun_multichip(8), eight ranks over gloo on this card, then
    entry()), scaling_bench's default (one rank over NCCL) and with two
    ranks sharing cuda:0 over gloo, and dryrun_multichip(1) over NCCL in
    this process."""
    from tfhe_tpu_torch import graft_entry

    runs = [start_entry("graft_entry", "--backend", "gloo"),
            start_entry("tools.scaling_bench", "--virtual-devices", "2"),
            start_entry("tools.scaling_bench")]
    try:
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(1)
        one_s = time.perf_counter() - t0
        rc, out, err, secs = finish_entry(runs[0])
        shared, default = finish_entry(runs[1]), finish_entry(runs[2])
    finally:
        for run in runs:
            kill_entry(run)
    entry_ok("graft_entry --backend gloo", rc, out, err)
    lines = out.strip().splitlines()
    counts = logged_launches(err, "entry()")
    check("dryrun_multichip(8): mesh=(4,2) OK" in lines
          and lines[-1] == "entry(): compiled + ran, out batch (16,)"
          and counts.get("blind_rotate") == 1,
          f"graft_entry: {lines}, launches {counts}")
    print(f"[18 twins] (b) python -m tfhe_tpu_torch.graft_entry --backend "
          f"gloo: {' / '.join(lines)} | entry() launches {counts} | "
          f"{secs:.1f} s | {card}", flush=True)
    print(f"[18 twins] (b) dryrun_multichip(1) over NCCL: OK | {one_s:.1f} s"
          f" | {card}", flush=True)
    scaling_checked((), (1,), default, "one rank over NCCL, run beside "
                    "(b)", card)
    scaling_checked(("--virtual-devices", "2"), (1, 2), shared,
                    "ranks sharing cuda:0 over gloo, run beside (b): the "
                    "path, not a scaling figure", card)


def phase18_pbs(card, phase10_rate):
    """(c) pbs_bench: 4096/4096, within PBS_AGREE of phase 10's rate (both
    time the second of two LUT calls over 4096 messages)."""
    import re

    rc, out, err, secs = run_entry("tools.pbs_bench")
    entry_ok("pbs_bench", rc, out, err)
    line = out.strip().splitlines()[-1]
    m = re.fullmatch(r"128_pbs: (\d+) LUT4/s, correct (\d+)/(\d+)", line)
    check(m is not None and int(m[2]) == int(m[3]) == BATCH,
          f"pbs_bench: {line!r}")
    off = int(m[1]) / phase10_rate - 1
    check(abs(off) <= PBS_AGREE,
          f"pbs_bench {m[1]} LUT4/s against phase 10's {phase10_rate:.1f}: "
          f"{100 * off:+.1f}%")
    print(f"[18 twins] (c) pbs_bench: {line} | phase 10 {phase10_rate:.1f} "
          f"LUTs/s, {100 * off:+.1f}% (limit {100 * PBS_AGREE:.0f}%) | "
          f"{secs:.1f} s | {card}", flush=True)


def phase18_profile(card):
    """(d) profile_bootstrap at 128 x 4096 and 80 x 1, 8, 64: its lines,
    and n launches of each rotation kernel in the traced layer."""
    import os
    import tempfile

    from tfhe_tpu_torch import params as presets

    heads = ("measured: ", "byte-MACs: ", "HBM bytes: ", "ALU elems: ")
    for which, batch in PROFILE_RUNS:
        n_steps = {"128": presets.tfhe_parameters_128,
                   "80": presets.tfhe_parameters_80}[which]().lwe_size
        with tempfile.TemporaryDirectory(prefix="chip_smoke18_") as tmp:
            rc, out, err, secs = run_entry(
                "tools.profile_bootstrap", str(batch), tmp,
                env={"PROFILE_PARAMS": which})
            entry_ok(f"profile_bootstrap {which} {batch}", rc, out, err)
            lines = out.strip().splitlines()[-4:]
            check([ln[:len(h)] for ln, h in zip(lines, heads)] == list(heads),
                  f"profile_bootstrap {which} {batch}: {lines}")
            with open(os.path.join(tmp, "trace.json")) as f:
                names = [e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"]
        kinds = [sum(k in name for name in names) for k in ROTATION_KERNELS]
        check(kinds == [n_steps] * len(ROTATION_KERNELS),
              f"profile_bootstrap {which} {batch}: rotation launches "
              f"{kinds}, expected {n_steps} each")
        print(f"[18 profile] PROFILE_PARAMS={which} batch {batch}: "
              f"{len(names)} launches = 2 x {n_steps} rotation + "
              f"{len(names) - 2 * n_steps} others | tool: "
              f"{' / '.join(lines)} | {secs:.1f} s | {card}", flush=True)


def scaling_checked(args, sizes, run, what, card):
    """A scaling_bench run's checks: exit 0, its size lines, the
    reference's JSON keys, one rotation launch in every rank."""
    rc, out, err, secs = run
    entry_ok(f"scaling_bench {' '.join(args)}", rc, out, err)
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1])
    check(list(rec) == ["metric", "per_device_batch", "rates",
                        "efficiency_at_max"]
          and list(rec["rates"]) == list(map(str, sizes))
          and rec["per_device_batch"] == SCALING_BATCH,
          f"scaling_bench {' '.join(args)}: {rec}")
    counts = [logged_launches(err, f"devices={d} rank {i}")
              for d in sizes for i in range(d)]
    check(all(c.get("blind_rotate") == 1 for c in counts),
          f"scaling_bench ranks' launches {counts}")
    print(f"[18 twins] (e) scaling_bench {' '.join(args) or '(default)'}, "
          f"128 preset, {what}: {' / '.join(lines)} | every output correct,"
          f" one rotation launch a rank | {secs:.1f} s | {card}", flush=True)


def phase18_twins(dev, card, real_key, phase10_rate):
    """The last entry-point twins, each a subprocess but (a)'s checks: the
    timed runs (pbs_bench, the profiles) one at a time, then the dry runs
    and the scaling runs together."""
    fresh_device(dev)
    t_phase = time.perf_counter()
    phase18_entry(dev, card, real_key)
    phase18_pbs(card, phase10_rate)
    phase18_profile(card)
    phase18_beside(card)
    print(f"[18 twins] phase 18 took {time.perf_counter() - t_phase:.1f} s | "
          f"{card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import tfhe_tpu_torch as tp
    from tfhe_tpu_torch.ops import _build, dots

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
    for kernel in ("rotate_decompose_kernelILi1ELb0E",
                   "rotate_decompose_kernelILi2ELb0E",
                   "rotate_decompose_kernelILi8ELb0E",
                   "rotate_decompose_kernelILi8ELb1E",
                   "rotate_decompose_kernelILi16ELb0E",
                   "leaf_dots_kernelILi1EE", "leaf_dots_kernelILi2EE",
                   "mk_unit_dots_kernelILi1EE", "mk_unit_dots_kernelILi2EE",
                   "expand_kernelILb0EE", "expand_kernelILb1EE",
                   "rotate_decompose_dense_kernelILi2E",
                   "rotate_decompose_dense_kernelILi8E",
                   "fused_step_kernelILi2ELb0E", "fused_step_kernelILi4ELb0E",
                   "fused_step_kernelILi8ELb0E",
                   "fused_step_kernelILi8ELb1E"):
        at = next((i for i, ln in enumerate(log)
                   if "Compiling entry function" in ln and kernel in ln), None)
        used = next((x for x in log[at:] if "Used" in x), None) \
            if at is not None else None
        check(used is not None, f"no ptxas report for {kernel}")
        report.append(f"{kernel}: {used.split(':', 1)[1].strip()}")
    spills = [ln for ln in log if "spill" in ln and "0 bytes spill stores, "
              "0 bytes spill loads" not in ln]
    # the dots kernels' dynamic shared memory: the ring and each
    # warpgroup's M blocks' sums, at 64 rows a block and at 128 (M = 8)
    ring = ", ".join(
        f"M={m} r={r}: {dots.ring_stages(m, r)} slots, "
        f"{dots.smem_bytes(m, dots.ring_stages(m, r), r)} bytes"
        for m, r in ((1, 64), (2, 64), (4, 64), (8, 64), (8, 128)))
    print(f"[2 build] {build_s:.2f} s, {len(_build._SOURCES)} sources in "
          f"parallel | " + " | ".join(report)
          + f" | kernels with spills: {len(spills)} | dots shared memory "
          f"per block: {ring}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ks = phase3(gen, card)
    torch.cuda.empty_cache()
    phase4_rate, real_key = phase4_baked(tp, ks, dev, card)
    phase5_compact(tp, ks, dev, card)
    phase6_three_forms(tp, ks, dev, card)
    phase7_default_preset(tp, dev, card)
    phase8_mk_two_party(tp, ks, dev, card)
    phase9_mk_more_parties(tp, dev, card)
    phase10_rate = phase10_pbs(tp, ks, dev, card)
    phase11_radix(tp, dev, card)
    phase12_radix_reliable(tp, dev, card)
    phase13_circuits_netlist(tp, dev, card)
    wire = phase14_wire(tp, dev, card)
    phase15_jobs_debug_profiling(tp, ks, dev, card, wire)
    del wire
    phase16_multi_device(tp, dev, card, phase4_rate)
    phase17_entry_points(dev, card, phase4_rate)
    phase18_twins(dev, card, real_key, phase10_rate)

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
