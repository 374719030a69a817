"""PBS LUT throughput at the PBS-retuned preset.

    python -m tfhe_tpu_torch.tools.pbs_bench
    python -m tfhe_tpu_torch.tools.pbs_bench --device cpu --params toy \\
        --batch 64

The twin of the reference's `tools/pbs_bench.py`: keygen of
`tfhe_parameters_128_pbs` from seed 7, the messages i % 4 of a batch of
4096, the LUT [2, 0, 3, 1]; one untimed `programmable_bootstrap`, then one
timed on its output (host clock ended by a synchronize). Prints
"128_pbs: <n> LUT4/s, correct <c>/<batch>" against lut[lut[m]]. Nothing
shrinks unless asked: `--params toy` and `--batch` are for the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import api, pbs
from .. import params as presets
from ..utils.entry import add_device_argument, barrier, entry_device

PRESETS = {"128_pbs": presets.tfhe_parameters_128_pbs,
           "toy": presets.tfhe_parameters_toy}
SEED = 7
SPACE = 4
LUT = [2, 0, 3, 1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", choices=list(PRESETS), default="128_pbs")
    ap.add_argument("--batch", type=int, default=4096)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = entry_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk, ck = api.make_key_pair(gen, PRESETS[args.params]())
    bk, ks = ck.bootstrap_key, ck.keyswitch_key
    msgs = torch.arange(args.batch, device=dev) % SPACE
    lut = torch.tensor(LUT, dtype=torch.int32, device=dev)
    px = pbs.encrypt_pbs(gen, sk, msgs, SPACE)
    out = pbs.programmable_bootstrap(bk, ks, lut, px, SPACE)
    barrier(dev)
    t0 = time.perf_counter()
    out = pbs.programmable_bootstrap(bk, ks, lut, out, SPACE)
    barrier(dev)
    dt = time.perf_counter() - t0
    got = pbs.decrypt_pbs(sk, out, SPACE)
    correct = int((got == lut[lut[msgs]]).sum())
    print(f"{args.params}: {args.batch / dt:.0f} LUT4/s, correct "
          f"{correct}/{args.batch}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
