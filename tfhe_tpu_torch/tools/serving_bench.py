"""Serving-tier sweep: baked against compact keys across batch sizes.

    python -m tfhe_tpu_torch.tools.serving_bench           # 128fast and 80
    TFHE_TPU_SERVE_PRESETS=128fast,128fast8,80 python -m ...
    TFHE_TPU_SERVE_SMALL=1 python -m ... --device cpu      # toy, plumbing

The twin of the reference's `tools/serving_bench.py`. For each preset and
key form it times a chain of 8 dependent NAND layers at batches 1, 8, 64,
512 and 4096 (one warm-up chain first, the timed one ended by a
synchronize) and prints one JSON line per batch: `preset`, `form`,
`batch`, `key_mb` (the bootstrap and keyswitch tensors' bytes, MiB),
`ms_per_layer`, `gates_per_sec`, and `correct` of `of`, the decrypt-level
check of the timed chain's outputs (a wrong gate is not a faster gate).
128fast8 runs compact only: its M=1 baked form is a ~13 GB copy of the
key. The log on stderr gives each form's counters (kernel launches,
rotation paths, table builds) and the host seconds of its table builds.
TFHE_TPU_SERVE_SMALL=1 runs toy parameters at batches 1 and 2 with a
chain of 2, and marks each line "small_toy_params": true; nothing shrinks
unless asked.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial

import torch

from .. import api, gates, tuning
from .. import params as presets
from ..bench import nand_chain, plain_nand
from ..ops import build_seconds, launches, reset_launches
from ..utils.entry import (
    add_device_argument,
    barrier,
    device_name,
    entry_device,
    log,
)

PRESETS = {
    "128fast": presets.tfhe_parameters_128_fast,
    "128fast8": presets.tfhe_parameters_128_fast8,
    "80": presets.tfhe_parameters_80,
    "128": presets.tfhe_parameters_128,
    "toy": presets.tfhe_parameters_toy,
}
BATCHES = (1, 8, 64, 512, 4096)
CHAIN = 8


def key_mib(ck) -> float:
    return (ck.bootstrap_key.baked.numel()
            + ck.keyswitch_key.table_limbs.numel()) / 2**20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    dev = entry_device(ap.parse_args(argv).device)
    small = bool(int(os.environ.get("TFHE_TPU_SERVE_SMALL", "0")))
    names = os.environ.get("TFHE_TPU_SERVE_PRESETS", "128fast,80").split(",")
    unknown = [n for n in names if n not in PRESETS]
    if unknown:
        raise SystemExit(f"TFHE_TPU_SERVE_PRESETS: unknown {unknown}; one of "
                         f"{','.join(PRESETS)}")
    batches = (1, 2) if small else BATCHES
    chain = 2 if small else CHAIN
    log(f"serving sweep: device={device_name(dev)} presets={names} "
        f"batches={batches} chain={chain}")

    for name in names:
        params = PRESETS["toy" if small else name]()
        forms = ((("compact", 0),) if name == "128fast8"
                 else (("baked", -1), ("compact", 0)))
        for form, budget in forms:
            with tuning.override(bs_bake_budget=budget):
                sk, ck = api.make_key_pair(
                    torch.Generator(device=dev).manual_seed(123), params)
            barrier(dev)
            log(f"{name}/{form}: bk "
                f"{ck.bootstrap_key.baked.numel() / 2**20:.1f} MB + ks "
                f"{ck.keyswitch_key.table_limbs.numel() / 2**20:.1f} MB")
            extra = {"small_toy_params": True} if small else {}
            nand = partial(gates.gate_nand, ck)
            wrappers = reset_launches()
            for b_sz in batches:
                gen = torch.Generator(device=dev).manual_seed(1)
                idx = torch.arange(b_sz, device=dev)
                xb, yb = idx % 2 == 0, idx % 3 == 0
                bx = api.encrypt(gen, sk, xb)
                by = api.encrypt(gen, sk, yb)
                out = nand_chain(nand, bx, by, chain)
                barrier(dev)
                t0 = time.perf_counter()
                out = nand_chain(nand, out, by, chain)
                barrier(dev)
                dt = (time.perf_counter() - t0) / chain
                want = nand_chain(plain_nand, xb, yb, 2 * chain)
                print(json.dumps({
                    "preset": name, "form": form, "batch": b_sz,
                    "key_mb": round(key_mib(ck), 1),
                    "ms_per_layer": round(dt * 1e3, 2),
                    "gates_per_sec": round(b_sz / dt, 1),
                    "correct": int((api.decrypt(sk, out) == want).sum()),
                    "of": b_sz, **extra,
                }), flush=True)
            log(f"{name}/{form} kernel launches: {launches(wrappers)}")
            log(f"{name}/{form} builds, host s: {build_seconds()}")
            del sk, ck, nand
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
