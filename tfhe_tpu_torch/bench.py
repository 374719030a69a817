"""Benchmark: batched bootstrapped-NAND throughput on one card.

    python -m tfhe_tpu_torch.bench                 # on the card
    TFHE_TPU_BENCH_PARAMS=toy python -m tfhe_tpu_torch.bench --device cpu

The twin of the reference's `bench.py`. Prints ONE JSON line on stdout:

  {"metric": "nand_bootstraps_per_sec_128bit", "value": N, "unit": "gates/s",
   "vs_baseline": N / 1e4, "params": ..., "security_core_svp_bits": ...,
   "correct": ..., "of": ...}

vs_baseline is the ratio against the north star of 1e4 bit-exact gate
bootstraps per second per chip (BASELINE.json), given only for the presets
at the 128-bit level ("128" and its re-splits "128fast" and "128fast8",
which rate to the same core-SVP bits); other presets get null. `correct`
of `of` is the decrypt-level check of the last layer's outputs: a wrong
gate is not a faster gate.

Env knobs: TFHE_TPU_BENCH_BATCH (default 4096 on the card, 8 with
`--device cpu`), TFHE_TPU_BENCH_ITERS (default 4), TFHE_TPU_BENCH_PARAMS
(128fast|128|128fast8|80|toy; default 128fast). The timed region is
iters + 1 chained `gate_nand` layers, issued from the host and ended by a
synchronize; one untimed layer before it builds and loads the kernels.
The log on stderr names the device, the host seconds of each table and
library built through the first layer (`built.*`), and the counters of the
timed layers: kernel launches, the rotation's path, any table built again.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial

import torch

from . import api, gates, tuning
from . import params as presets
from .ops import build_seconds, launches, reset_launches
from .tools.security_estimate import estimate_preset
from .utils.entry import (
    add_device_argument,
    barrier,
    device_name,
    entry_device,
    log,
)

PRESETS = {
    "128": presets.tfhe_parameters_128,
    "128fast": presets.tfhe_parameters_128_fast,
    "128fast8": presets.tfhe_parameters_128_fast8,
    "80": presets.tfhe_parameters_80,
    "toy": presets.tfhe_parameters_toy,
}
AT_128_LEVEL = ("128", "128fast", "128fast8")
SEED = 123


def plain_nand(x, y):
    return ~(x & y)


def nand_chain(nand, x, y, layers: int):
    """`layers` dependent NAND layers: nand(x, y), then nand(out, y).
    `nand` is `partial(gates.gate_nand, ck)` on ciphertexts, or
    `plain_nand` on bits for the outputs the chain must decrypt to."""
    out = nand(x, y)
    for _ in range(layers - 1):
        out = nand(out, y)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    dev = entry_device(ap.parse_args(argv).device)
    batch = int(os.environ.get("TFHE_TPU_BENCH_BATCH",
                               "4096" if dev.type == "cuda" else "8"))
    iters = int(os.environ.get("TFHE_TPU_BENCH_ITERS", "4"))
    which = os.environ.get("TFHE_TPU_BENCH_PARAMS", "128fast")
    if which not in PRESETS:
        raise SystemExit(f"TFHE_TPU_BENCH_PARAMS={which!r}: not one of "
                         f"{'|'.join(PRESETS)}")
    params = PRESETS[which]()
    log(f"bench: device={device_name(dev)} batch={batch} iters={iters} "
        f"params={which}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    # The k=8/N=128 geometry is compact by design: at M=1 the baked form
    # is a ~13 GB copy of the key with no block-recombine advantage.
    with tuning.override(**({"bs_bake_budget": 0} if which == "128fast8"
                             else {})):
        sk, ck = api.make_key_pair(gen, params)
    barrier(dev)
    log(f"keygen: {time.perf_counter() - t0:.1f}s "
        f"(key form {ck.bootstrap_key.layout})")

    idx = torch.arange(batch, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    ct_x = api.encrypt(gen, sk, bits_x)
    ct_y = api.encrypt(gen, sk, bits_y)

    barrier(dev)
    t0 = time.perf_counter()
    gates.gate_nand(ck, ct_x, ct_y)
    barrier(dev)
    log(f"first call (compile + run): {time.perf_counter() - t0:.1f}s")
    log(f"builds through the first call, host s: {build_seconds()}")

    wrappers = reset_launches()
    t0 = time.perf_counter()
    out = nand_chain(partial(gates.gate_nand, ck), ct_x, ct_y, iters + 1)
    barrier(dev)
    dt = time.perf_counter() - t0
    throughput = batch * (iters + 1) / dt
    log(f"{iters + 1} layers x {batch} gates in {dt:.3f}s -> "
        f"{throughput:.0f} gates/s")
    log(f"kernel launches in the timed layers: {launches(wrappers)}")

    # Correctness (decrypt level): the NAND(NAND(x, y), y) chain.
    want = nand_chain(plain_nand, bits_x, bits_y, iters + 1)
    n_bad = int((api.decrypt(sk, out) != want).sum())
    log(f"correctness: {batch - n_bad}/{batch} decrypt correctly")
    if n_bad:
        log("WARNING: decryption errors present")

    print(json.dumps({
        "metric": "nand_bootstraps_per_sec_128bit",
        "value": round(throughput, 1),
        "unit": "gates/s",
        "vs_baseline": (round(throughput / 1e4, 4) if which in AT_128_LEVEL
                        else None),
        "params": which,
        "security_core_svp_bits": round(estimate_preset(params)["bits"], 1),
        "correct": batch - n_bad,
        "of": batch,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
