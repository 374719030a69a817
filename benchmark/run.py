"""Run one cell of the benchmark of tfhe_tpu_torch once, on the card.

    python3 -m benchmark.run --workload cggi128.nand_b4096 --seed 7 \\
        --seconds 40 --trace 0

From the root of a checkout. `BENCHMARK.json` names the cells; a cell's
traffic is `benchmark/workloads/<cell>.json`, its unit of work (the
traffic's `gate`) `benchmark/units/<gate>.py`, its configuration
`benchmark/configs/<config>.json`, and each metric's reader
`benchmark/metrics/<metric>.py`: adding a cell, a unit of work, a
configuration or a metric adds files and entries and edits nothing here.

A run: set-up (kernel build on a checkout's first run, then load; the key
material from the seed; the program's cloud key from it; the operand
pool; one warm unit), the window of `--seconds`, then the comparison with
the plain reference on a sample of the window's rows. With `--trace 1` a
short stretch before the window runs under torch.profiler and the run
reports the cell's per-layer metrics instead of its end-to-end ones. The
last line on stdout is the result as one JSON object; the set-up split,
the kernel launches and the compared numbers beside their limits go to
stderr. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tfhe_tpu")
QUEUED_LAYERS = 2  # chained loop: layers in flight on the device


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def since_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    with open(bench / kind / f"{name}.json") as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str):
    return _load_module(BENCH / "metrics" / f"{name}.py",
                        "benchmark.metrics." + name.replace(".", "_"))


def load_unit(gate: str, bench: Path = BENCH):
    """The unit of work `gate`: `units/<gate>.py` of the cell's bench
    directory, else of `benchmark/`. A unit file supplies:

    * `draw(gen, shape)`: plaintexts, one a row, [*shape], from a CPU
      `torch.Generator`;
    * `phase(plain)`: their torus phases, int32 [*plain.shape, *row]; the
      row shape it adds is that of a row's bodies, so a batch of rows is a
      ciphertext with `b` [*batch, *row] and `a` [*batch, *row, n] (single
      key) or [*batch, *row, P, n] (P parties);
    * `apply(x, y)`: the plaintext function of the two operands;
    * `decrypt(phase)`: the plaintexts of output rows from their phases
      [..., *row];
    * `program(scheme)`: the timed call of the port, f(cloud key, x, y),
      for the configuration's `scheme` (`cggi`, `mktfhe`);
    * `reference(ref, x_a, x_b, y_a, y_b)`: the output words (a, b)
      recomputed by the plain reference of `benchmark/reference/tfhe.py`,
      from the operands' words;
    * `rotations_per_row(p)`: the blind rotations one row of one unit
      runs under configuration `p`.
    """
    path = bench / "units" / f"{gate}.py"
    if not path.exists():
        path = BENCH / "units" / f"{gate}.py"
    return _load_module(path, "benchmark.units." + gate)


class Manifest:
    """`BENCHMARK.json`: the cells and the metrics each reports."""

    def __init__(self, data: dict):
        self.data = data
        self.cells = {w["name"]: w for w in data["workloads"]}

    @classmethod
    def load(cls, path: Path = ROOT / "BENCHMARK.json") -> "Manifest":
        with open(path) as f:
            return cls(json.load(f))

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics, or with `trace` its per-layer
        ones: those that list it, or list no cells and move a metric it
        reports."""
        e2e = [m for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


class Clock:
    """Host time and the device's queue: `sync` waits for the device;
    `mark` records a point in the queue and `wait_behind(k)` waits until at
    most k marks are unfinished (the CPU runs synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.marks.append(ev)

    def wait_behind(self, k: int):
        while len(self.marks) > k:
            self.marks.pop(0).synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest: Manifest | None = None,
             bench: Path = BENCH, program=None) -> dict:
    """One run of one cell; returns the result object. `program`, where
    given, stands in for `system.System` (the control, and the tests'
    broken programs)."""
    from . import inputs, system
    from .check import LIMITS, Recorder
    from .trace import UNIT_SPAN
    from .traffic import make_traffic

    manifest = manifest or Manifest.load()
    w = load_json("workloads", cell, bench)
    p = load_json("configs", w["config"], bench)
    unit = load_unit(w["gate"], bench)
    dev = torch.device(device)
    clock = Clock(dev)
    setup = {"process_start_to_setup_s": since_start()}

    t = time.perf_counter()
    if clock.cuda:
        system.build_kernels()
    setup["kernel_build_and_load_s"] = time.perf_counter() - t
    system.use_tuning(p)
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = inputs.draw_keys(p, gen)
    clock.sync()
    setup["key_material_s"] = time.perf_counter() - t
    prog = (program or system.System)(p, keys, setup, unit)
    t = time.perf_counter()
    traffic = make_traffic(w, seed, unit)
    pool_words = inputs.encrypt(p, keys, unit.phase(traffic.pool), gen)
    x0_words = inputs.encrypt(p, keys, unit.phase(traffic.first), gen)
    pool = [prog.wrap(pool_words[0][i], pool_words[1][i])
            for i in range(w["pool"])]
    x = prog.wrap(*x0_words)
    clock.sync()
    setup["ciphertexts_s"] = time.perf_counter() - t
    rec = Recorder(p, keys, traffic, x0_words, pool_words)
    chained = w["loop"] == "chained"

    def to_host(out):
        a, b = prog.words(out)
        rows = w["batch"]
        return torch.cat([a.reshape(rows, -1), b.reshape(rows, -1)],
                         dim=1).cpu()

    t = time.perf_counter()
    warm = prog.gate(x, pool[traffic.slot(0)])
    if chained:
        rec.keep_layer(0, prog.words(x), prog.words(warm))
    else:
        rec.keep_request(0, to_host(warm))
    rec.reset()
    del warm
    clock.sync()
    setup["warm_unit_s"] = time.perf_counter() - t

    units = 0
    latencies = []

    def step(span):
        nonlocal x, units
        y = pool[traffic.slot(units)]
        if chained:
            with span(UNIT_SPAN):
                out = prog.gate(x, y)
            rec.keep_layer(units, prog.words(x), prog.words(out))
            clock.mark()
            clock.wait_behind(QUEUED_LAYERS)
        else:
            t0 = time.perf_counter()
            with span(UNIT_SPAN):
                out = prog.gate(x, y)
                host = to_host(out)
            latencies.append(time.perf_counter() - t0)
            rec.keep_request(units, host)
        x = out
        units += 1

    def no_span(_):
        return contextlib.nullcontext()

    view, launches = None, {}
    setup_s = since_start()
    if trace:
        view, launches = traced_stretch(step, w["trace_units"], clock,
                                        system)
        latencies.clear()
    t0 = time.perf_counter()
    first = units
    while True:
        step(no_span)
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    timed_units = units - first
    mem_peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    key_bytes = prog.key_bytes
    form = prog.form
    del prog, pool, x
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, compared = rec.judge(w["check_sample"], seed, dev)
    check_s = time.perf_counter() - t

    run = types.SimpleNamespace(
        cell=cell, config=p, workload=w, batch=w["batch"], loop=w["loop"],
        rotations_per_row=unit.rotations_per_row(p),
        setup_s=setup_s, window_s=window_s, units=timed_units,
        latencies_s=latencies, mem_peak_bytes=mem_peak, key_bytes=key_bytes,
        trace=view, launches=launches)
    metrics = {}
    for m in manifest.metrics(cell, trace):
        value = load_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(f"cell {cell} seed {seed}: {p['name']} ({form}), {w['loop']} loop "
        f"at batch {w['batch']}, device {device_kind(dev)}")
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f"; setup_s {setup_s:.3f}")
    log(f"window: {timed_units} units in {window_s:.3f} s; compared "
        f"{compared} rows with the reference in {check_s:.1f} s")
    if trace:
        log(f"traced stretch: {w['trace_units']} units, launches {launches}")
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)
    for k in LIMITS:
        log(f"check {k}: {checks[k]} (limit {LIMITS[k]})")
    result = {
        "correct": correct,
        "attempted": rec.units * w["batch"],
        "failed": checks["wrong_decryptions"],
        "metrics": metrics,
        "device": {"platform": "gpu" if clock.cuda else "cpu",
                   "kind": device_kind(dev), "count": 1,
                   "memory_peak_bytes": mem_peak},
    }
    if trace:
        result["device"].update(busy_s=view.busy_s(), window_s=view.window_s())
        result["breakdown"] = {"device_ops": view.top_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    return result


def traced_stretch(step, count: int, clock: Clock, system):
    """`count` units under torch.profiler, each in a `bench.unit` span
    (the program opens its own `tfhe.*` spans inside); the device is idle
    at the start and drained at the end. Returns the trace and the
    wrappers' launch counts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import TraceView

    activities = [ProfilerActivity.CPU]
    if clock.cuda:
        activities.append(ProfilerActivity.CUDA)
    clock.sync()
    wrappers = system.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            for _ in range(count):
                step(record_function)
            clock.wait_behind(0)
            clock.sync()
        launches = system.read_launches(wrappers)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        view = TraceView.load(path)
    return view, launches


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest.load()
    if args.workload not in manifest.cells:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    chips = manifest.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"cell {args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", manifest)
    found = forbidden_modules()
    if found:
        log(f"the process loaded {found}: the port must not use JAX or the "
            "JAX package")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
