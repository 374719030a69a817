"""Profile one batched gate bootstrap: a torch.profiler trace and the
roofline against the measured time.

    python -m tfhe_tpu_torch.tools.profile_bootstrap [batch] [trace_dir]
    PROFILE_PARAMS=80 python -m tfhe_tpu_torch.tools.profile_bootstrap 1
    python -m tfhe_tpu_torch.tools.profile_bootstrap --device cpu

The twin of the reference's `tools/profile_bootstrap.py`. Keygen, one
untimed `gate_nand`, then one layer under `utils.profiling.trace`, ended
by a synchronize: the Chrome trace `trace_dir/trace.json` (host ops, and
on a card every kernel with its start and duration). It prints the
measured time (profiler start and stop included, as the reference's) and
`bootstrap_roofline`'s counts with the card's floors and their shares.
Env: PROFILE_PARAMS=128|80|toy (default 128). Batch defaults to 4096 on
the card and 8 on the CPU, where the parameters are toy whatever is asked,
as in the reference.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import api, gates
from .. import params as presets
from ..utils.entry import add_device_argument, barrier, entry_device
from ..utils.profiling import bootstrap_roofline, trace

PRESETS = {"128": presets.tfhe_parameters_128,
           "80": presets.tfhe_parameters_80,
           "toy": presets.tfhe_parameters_toy}
SEED = 123


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int)
    ap.add_argument("trace_dir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "tfhe_tpu_torch_trace"))
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    on_card = dev.type == "cuda"
    batch = args.batch if args.batch is not None else \
        (4096 if on_card else 8)
    which = os.environ.get("PROFILE_PARAMS", "128")
    if which not in PRESETS:
        raise SystemExit(f"PROFILE_PARAMS={which!r}: not one of "
                         f"{'|'.join(PRESETS)}")
    params = PRESETS[which if on_card else "toy"]()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk, ck = api.make_key_pair(gen, params)
    barrier(dev)
    idx = torch.arange(batch, device=dev)
    x = api.encrypt(gen, sk, idx % 2 == 0)
    y = api.encrypt(gen, sk, idx % 3 == 0)
    out = gates.gate_nand(ck, x, y)
    barrier(dev)

    t0 = time.perf_counter()
    with trace(args.trace_dir):
        out = gates.gate_nand(ck, out, y)
        barrier(dev)
    dt = time.perf_counter() - t0
    print(f"trace written to {args.trace_dir}", flush=True)

    bk = ck.bootstrap_key
    rl = bootstrap_roofline(params, batch, depth=bk.depth or 2,
                            block=bk.block)
    util = rl.utilization(dt)
    print(f"measured: {dt * 1e3:.1f} ms for {batch} gates "
          f"({batch / dt:.0f} gates/s)")
    print(f"byte-MACs: {rl.byte_macs / 1e9:.1f} G  "
          f"(int8 floor {rl.int8_floor_s * 1e3:.1f} ms, "
          f"util {util['int8'] * 100:.0f}%)")
    print(f"HBM bytes: {rl.hbm_bytes / 1e9:.1f} GB  "
          f"(BW floor {rl.hbm_floor_s * 1e3:.1f} ms, "
          f"util {util['hbm'] * 100:.0f}%)")
    print(f"ALU elems: {rl.alu_elems / 1e9:.1f} G", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
