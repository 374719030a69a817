"""Extended benchmark suite: the measured configurations of BASELINE.md.

    python -m tfhe_tpu_torch.bench_suite                  # every section
    TFHE_SUITE_SECTIONS=fast,mk2 python -m tfhe_tpu_torch.bench_suite
    TFHE_SUITE_SMALL=1 python -m tfhe_tpu_torch.bench_suite --device cpu

The twin of the reference's `bench_suite.py`: one JSON line per
measurement on stdout (the headline metric stays in `bench`). Sections:

  80bit:          single NAND latency (baked key, 16 chained calls, compact
                  key) + the 10-gate set
  128core:        batched NAND + PBS LUT4 + 8-bit ripple adder + radix
                  adder, all on the reference's 128-bit preset
  fast:           batched NAND on 128_fast
  fast8:          batched NAND on the k=8/N=128 reliability tier (compact)
  radix_preset:   radix adder on 128_radix
  radix_reliable: the <=1e-9/word config (manylut off, compact key)
  mk2 / mk2_ref:  2-party MK NAND (the lownoise headline, and the
                  reference-fidelity preset with its labelled ~1.5%/gate
                  failure)
  mk4 / mk8:      4- and 8-party MK NAND

Without TFHE_SUITE_SECTIONS this is the orchestrator: each section runs in
its own subprocess (`TFHE_SUITE_SECTIONS=name`), so no process holds two
presets' keys, with a time limit each (TFHE_SUITE_SECTION_TIMEOUT_S,
default 5400); a failed section prints a `section_<name>` line with value
-1 and the suite exits 1. Error counts ride in the lines (`correct`/`of`,
`errors`) and are never hidden.

TFHE_SUITE_SMALL=1 runs toy parameters at small batches, and every line
then carries "small_toy_params": true. Nothing shrinks unless asked. The
log on stderr gives each section's counters (kernel launches, rotation
paths, table builds) and the host seconds of its table builds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from functools import partial

import torch

from . import api, circuits, gates, mk, pbs, radix, tuning
from . import params as presets
from .bench import nand_chain, plain_nand
from .ops import build_seconds, launches, reset_launches
from .utils.entry import (
    add_device_argument,
    barrier,
    device_name,
    entry_device,
    log,
)


@dataclass(frozen=True)
class Run:
    """One section's run: the device and whether toy sizes were asked."""

    dev: torch.device
    small: bool

    def emit(self, metric, value, unit, extra=None):
        rec = {"metric": metric, "value": round(value, 2), "unit": unit}
        if extra:
            rec.update(extra)
        if self.small:
            # toy parameters: keep the preset/tier labels the sections
            # attach from passing for production measurements
            rec["small_toy_params"] = True
        print(json.dumps(rec), flush=True)

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(seed)

    def bits(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.bool, device=self.dev)

    def arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.dev)


def sec_80bit(run: Run):
    """Single NAND latency (baked key / 16 chained calls / compact key) and
    the 10-gate set, on the 80-bit (tutorial) preset."""
    p80 = presets.tfhe_parameters_toy() if run.small \
        else presets.tfhe_parameters_80()
    sk, ck = api.make_key_pair(run.gen(123), p80)
    barrier(run.dev)

    gen = run.gen(1)
    one_x = api.encrypt(gen, sk, run.bits([True]))
    one_y = api.encrypt(gen, sk, run.bits([False]))
    # NAND(., False) is True: every output of the chains below decrypts so
    nand = partial(gates.gate_nand, ck)
    out = nand(one_x, one_y)
    barrier(run.dev)
    reps = 5
    t0 = time.perf_counter()
    out = nand_chain(nand, out, one_y, reps)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    run.emit("single_nand_latency_80bit", dt / reps * 1e3, "ms",
             {"correct": int(api.decrypt(sk, out).sum()), "of": 1})

    # N dependent NANDs issued back to back, one synchronize at the end:
    # the per-gate latency of pipelined serving.
    chain_n = 2 if run.small else 16
    out = nand_chain(nand, one_x, one_y, chain_n)
    barrier(run.dev)
    t0 = time.perf_counter()
    out = nand_chain(nand, out, one_y, chain_n)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    run.emit("chained_nand_device_latency_80bit", dt / chain_n * 1e3, "ms",
             {"chain": chain_n, "correct": int(api.decrypt(sk, out).sum()),
              "of": 1})

    # The COMPACT (multi-tenant) key: prepared limbs, each step's operand
    # expanded at gate time; the same seed gives the same secret key.
    with tuning.override(bs_bake_budget=0):
        skc, ckc = api.make_key_pair(run.gen(123), p80)
    barrier(run.dev)
    if not ckc.bootstrap_key.compact:
        raise RuntimeError("bs_bake_budget=0 gave a baked key")
    nandc = partial(gates.gate_nand, ckc)
    outc = nandc(one_x, one_y)
    barrier(run.dev)
    t0 = time.perf_counter()
    outc = nand_chain(nandc, outc, one_y, reps)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    run.emit("single_nand_latency_compact_key", dt / reps * 1e3, "ms",
             {"key_mb": round(ckc.bootstrap_key.baked.numel() / 2**20, 1),
              "correct": int(api.decrypt(skc, outc).sum()), "of": 1})
    del skc, ckc, outc, nandc

    xs = run.bits([False, False, True, True])
    ys = run.bits([False, True, False, True])
    gen = run.gen(3)
    cx = api.encrypt(gen, sk, xs)
    cy = api.encrypt(gen, sk, ys)
    table = {
        gates.gate_nand: lambda x, y: ~(x & y),
        gates.gate_and: lambda x, y: x & y,
        gates.gate_or: lambda x, y: x | y,
        gates.gate_xor: lambda x, y: x ^ y,
        gates.gate_xnor: lambda x, y: ~(x ^ y),
        gates.gate_nor: lambda x, y: ~(x | y),
        gates.gate_andny: lambda x, y: ~x & y,
        gates.gate_andyn: lambda x, y: x & ~y,
        gates.gate_orny: lambda x, y: ~x | y,
        gates.gate_oryn: lambda x, y: x | ~y,
    }
    ok = sum(int(torch.equal(api.decrypt(sk, fn(ck, cx, cy)), ref(xs, ys)))
             for fn, ref in table.items())
    run.emit("gate_set_correct", ok, f"/{len(table)} gates")


def _words(run: Run, n: int):
    """The suite's 8-bit operands: a = i % 251, b = 7 i % 253, and the sum
    that a + b + b must give mod 256."""
    i = run.arange(n)
    a, b = i % 251, (i * 7) % 253
    return a, b, (a + 2 * b) % 256


def sec_128core(run: Run):
    """Batched NAND, PBS LUT4, the ripple-carry adder and the radix adder,
    all on the reference-geometry 128-bit preset (one 8.9 GB baked key)."""
    p128 = presets.tfhe_parameters_toy() if run.small \
        else presets.tfhe_parameters_128()
    gen = run.gen(7)
    sk2, ck2 = api.make_key_pair(gen, p128)
    barrier(run.dev)
    _nand_layers(run, sk2, ck2, gen, "batched_nand_throughput_128bit")
    B = 64 if run.small else 4096

    # programmable bootstrapping (4-entry LUT) throughput
    S = 4
    msgs = run.arange(B) % S
    lut = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=run.dev)
    px = pbs.encrypt_pbs(gen, sk2, msgs, S)
    bk, ks = ck2.bootstrap_key, ck2.keyswitch_key
    out_p = pbs.programmable_bootstrap(bk, ks, lut, px, S)
    barrier(run.dev)
    t0 = time.perf_counter()
    out_p = pbs.programmable_bootstrap(bk, ks, lut, out_p, S)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    got = pbs.decrypt_pbs(sk2, out_p, S)
    want = lut[lut[msgs]]  # chained: f(f(m))
    run.emit("pbs_lut4_throughput_128bit", B / dt, "luts/s",
             {"batch": B, "correct": int((got == want).sum()), "of": B})
    del px, out_p

    # 8-bit ripple-carry adder (error-COUNTED per word)
    W = 8 if run.small else 512
    av, bv, want = _words(run, W)
    ca = circuits.encrypt_word(gen, sk2, av, 8)
    cb = circuits.encrypt_word(gen, sk2, bv, 8)
    out = circuits.ripple_carry_add(ck2, ca, cb)
    barrier(run.dev)
    t0 = time.perf_counter()
    out = circuits.ripple_carry_add(ck2, out, cb)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    got = circuits.decrypt_word(sk2, out)
    run.emit("adder8_words_per_sec", W / dt, "adds/s",
             {"correct": int((got == want).sum()), "of": W})
    del ca, cb, out

    # 8-bit radix adder (base-4 digits on PBS: 1 rotation a bit), with
    # COUNTED word errors: the 128 preset's model failure is ~3.8e-3 a word
    # an add here (docs/leveled_mode.md 2b)
    dt, ok, Wr = _radix_add_timed(run, sk2, ck2, gen)
    run.emit("radix_adder8_words_per_sec", Wr / dt, "adds/s",
             {"correct": ok, "of": Wr, "params": "128"})


def _nand_layers(run: Run, sk, ck, gen, metric, extra=None):
    """One warm-up NAND layer, then `iters` timed chained layers,
    decrypt-checked."""
    B = 64 if run.small else 4096
    iters = 2 if run.small else 4
    xb, yb = run.arange(B) % 2 == 0, run.arange(B) % 3 == 0
    fx = api.encrypt(gen, sk, xb)
    fy = api.encrypt(gen, sk, yb)
    nand = partial(gates.gate_nand, ck)
    outf = nand(fx, fy)
    barrier(run.dev)
    t0 = time.perf_counter()
    outf = nand_chain(nand, outf, fy, iters)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    want = nand_chain(plain_nand, xb, yb, iters + 1)
    rec = {"batch": B, "correct": int((api.decrypt(sk, outf) == want).sum()),
           "of": B}
    if extra:
        rec.update(extra)
    run.emit(metric, B * iters / dt, "gates/s", rec)


def _batched_nand(run: Run, params_fn, metric, keygen_budget=None,
                  extra=None):
    """The batched-NAND sections: keygen (optionally under a bake-budget
    override), then `_nand_layers`."""
    params = presets.tfhe_parameters_toy() if run.small else params_fn()
    gen = run.gen(17)
    knobs = {} if keygen_budget is None else {"bs_bake_budget": keygen_budget}
    with tuning.override(**knobs):
        sk, ck = api.make_key_pair(gen, params)
    barrier(run.dev)
    _nand_layers(run, sk, ck, gen, metric, extra)


def sec_fast(run: Run):
    """Batched NAND at 128_fast (the `bench` headline configuration; the
    same lattice instances and security as the 128-bit preset)."""
    _batched_nand(run, presets.tfhe_parameters_128_fast,
                  "batched_nand_throughput_128fast")


def sec_fast8(run: Run):
    """The k=8/N=128 re-split (a reliability TIER: ~7e-9/gate model
    failure against 2e-38 at 128_fast). Compact by design: at M=1 the
    baked form is a ~13 GB copy, so keygen runs under bs_bake_budget=0."""
    _batched_nand(
        run, presets.tfhe_parameters_128_fast8,
        "batched_nand_throughput_128fast8", keygen_budget=0,
        extra={"tier": "~7e-9/gate model failure (docs/params_fast.md)"})


def _radix_add_timed(run: Run, sk, ck, gen):
    """a + b warm, then (a + b) + b timed, on 8-bit words. Returns
    (seconds, words correct, words)."""
    Wr = 8 if run.small else 4096
    rav, rbv, want = _words(run, Wr)
    ra = radix.encrypt_radix(gen, sk, rav, 8)
    rb = radix.encrypt_radix(gen, sk, rbv, 8)
    out_r = radix.radix_add(ck, ra, rb)
    barrier(run.dev)
    t0 = time.perf_counter()
    out_r = radix.radix_add(ck, out_r, rb)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    got = radix.decrypt_radix(sk, out_r)
    return dt, int((got == want).sum()), Wr


def sec_radix_preset(run: Run):
    """Radix adder on the radix-tuned preset (balanced l3b7 gadget +
    ks l4 base16: model failure 7.9e-5/word at unchanged rotation cost)."""
    gen = run.gen(41)
    sk, ck = api.make_key_pair(gen, presets.tfhe_parameters_toy()
                               if run.small
                               else presets.tfhe_parameters_128_radix())
    barrier(run.dev)
    dt, ok, Wr = _radix_add_timed(run, sk, ck, gen)
    run.emit("radix_adder8_words_per_sec_radix_preset", Wr / dt, "adds/s",
             {"correct": ok, "of": Wr, "params": "128radix"})


def sec_radix_reliable(run: Run):
    """The <=1e-9/word RELIABLE config: 128_radix_reliable with PBSmanyLUT
    OFF (model failure 1.6e-10/word, docs/leveled_mode.md 2b), on the
    compact key, as the reference serves it."""
    gen = run.gen(45)
    with tuning.override(radix_manylut=False, bs_bake_budget=0):
        sk, ck = api.make_key_pair(
            gen, presets.tfhe_parameters_toy() if run.small
            else presets.tfhe_parameters_128_radix_reliable())
        barrier(run.dev)
        dt, ok, Wr = _radix_add_timed(run, sk, ck, gen)
    run.emit("radix_adder8_words_per_sec_reliable", Wr / dt, "adds/s",
             {"correct": ok, "of": Wr, "params": "128radix_reliable",
              "manylut": False, "key_form": "compact",
              "model_failure_per_word": 1.6e-10})


def _mk_run(run: Run, parties, pmk, metric, seed, batch, extra=None):
    """The MK ceremony and timing protocol: shared key, per-party secret
    keys and cloud key parts, assembly, one warm-up NAND, one timed
    chained NAND layer ended by a synchronize, decrypt-COUNTED errors."""
    gen = run.gen(seed)
    shared = mk.make_shared_key(gen, pmk)
    sks, parts = [], []
    for _ in range(parties):
        s = api.make_secret_key(gen, pmk)
        sks.append(s)
        parts.append(mk.make_cloud_key_part(gen, s, shared))
    t0 = time.perf_counter()
    mck = mk.make_mk_cloud_key(parts)
    barrier(run.dev)
    log(f"mk expansion ({metric}): {time.perf_counter() - t0:.1f}s "
        f"(sparse={mck.bootstrap_key.sparse})")
    del parts
    Bm = 4 if run.small else batch
    m1 = run.arange(Bm) % 2 == 0
    e1 = mk.mk_encrypt(gen, sks, m1)
    e2 = mk.mk_encrypt(gen, sks, ~m1)
    out = mk.mk_gate_nand(mck, e1, e2)
    barrier(run.dev)
    t0 = time.perf_counter()
    out = mk.mk_gate_nand(mck, out, e2)
    barrier(run.dev)
    dt = time.perf_counter() - t0
    want = ~(~(m1 & ~m1) & ~m1)
    rec = {"batch": Bm,
           "errors": int((mk.mk_decrypt(sks, out) != want).sum())}
    if extra:
        rec.update(extra)
    run.emit(metric, Bm / dt, "gates/s", rec)


def sec_mk2(run: Run):
    """2-party MK NAND. The HEADLINE row runs the zero-error lownoise
    preset (the reference's own 2-party preset fails ~1.5% of gates,
    docs/mk_noise_budget.md)."""
    _mk_run(run, 2, mk.mktfhe_parameters_toy(2) if run.small
            else mk.mktfhe_parameters_2party_lownoise(),
            "mk2_nand_throughput", seed=21, batch=4096,
            extra={"preset": "2party_lownoise"})


def sec_mk2_ref(run: Run):
    """2-party MK NAND on the reference-fidelity preset, labelled with its
    intrinsic failure rate."""
    _mk_run(run, 2, mk.mktfhe_parameters_toy(2) if run.small
            else mk.mktfhe_parameters_2party(),
            "mk2_nand_throughput_reference_preset", seed=26, batch=4096,
            extra={"preset": "2party (reference fidelity; intrinsic "
                             "~1.5%/gate failure, docs/mk_noise_budget.md)"})


def sec_mk4(run: Run):
    """4-party MK NAND."""
    _mk_run(run, 4, mk.mktfhe_parameters_toy(4) if run.small
            else mk.mktfhe_parameters_4party(),
            "mk4_nand_throughput", seed=31, batch=4096)


def sec_mk8(run: Run):
    """8-party MK NAND (reference preset src/mk_api.jl:24-34) on the
    sparse-stored expanded key (nonzero blocks only)."""
    _mk_run(run, 8, mk.mktfhe_parameters_toy(8) if run.small
            else mk.mktfhe_parameters_8party(),
            "mk8_nand_throughput", seed=51, batch=1024)


SECTIONS = {
    "80bit": sec_80bit,
    "128core": sec_128core,
    "fast": sec_fast,
    "fast8": sec_fast8,
    "radix_preset": sec_radix_preset,
    "radix_reliable": sec_radix_reliable,
    "mk2": sec_mk2,
    "mk2_ref": sec_mk2_ref,
    "mk4": sec_mk4,
    "mk8": sec_mk8,
}


def orchestrate(device: str, run: Run) -> int:
    """Every section in a subprocess of its own, with a time limit each.
    Returns 1 if any section failed, else 0."""
    timeout_s = int(os.environ.get("TFHE_SUITE_SECTION_TIMEOUT_S", "5400"))
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))
    failed = []
    for name in SECTIONS:
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--device", device],
                env={**env, "TFHE_SUITE_SECTIONS": name},
                stdout=subprocess.PIPE, text=True, timeout=timeout_s)
            out, code = r.stdout, r.returncode
        except subprocess.TimeoutExpired as e:  # the child is killed
            out = e.stdout.decode() if isinstance(e.stdout, bytes) \
                else (e.stdout or "")
            code = f"timeout>{timeout_s}s"
        sys.stdout.write(out)
        sys.stdout.flush()
        log(f"[suite] section {name}: exit={code} "
            f"({time.perf_counter() - t0:.0f}s)")
        if code != 0:
            failed.append(name)
            run.emit(f"section_{name}", -1, "failed", {"exit_code": str(code)})
    if failed:
        # the partial lines are out, but the suite must not look green
        log(f"[suite] FAILED sections: {', '.join(failed)}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    run = Run(dev, small=bool(int(os.environ.get("TFHE_SUITE_SMALL", "0"))))
    names = os.environ.get("TFHE_SUITE_SECTIONS")
    if not names:
        log(f"[suite] device={device_name(dev)} small={run.small}")
        return orchestrate(args.device, run)
    names = [n.strip() for n in names.split(",")]
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; the sections are "
                         f"{', '.join(SECTIONS)}")
    for name in names:
        wrappers = reset_launches()
        SECTIONS[name](run)
        log(f"[suite] {name} kernel launches: {launches(wrappers)}")
        log(f"[suite] {name} builds, host s: {build_seconds()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
