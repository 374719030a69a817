"""The control of the comparison that decides `correct`: the plain reference
put in the program's place, computed in float32 (the precision below the
exact float64 that the configuration's integer arithmetic needs; TF32
off), driven through the same set-up, window and comparison as a run.
Every run of it has to come out not correct.

    python3 -m benchmark.control --workload cggi128.nand_b4096 \\
        --seeds 11 12 13 --seconds 1

One process, one line of JSON a seed on stdout: the compared numbers and
`correct`. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json

import torch

from .reference.tfhe import reference_for
from .run import Manifest, log, run_cell


class ControlProgram:
    """Stands in for `system.System`: the unit of work is the unit's
    reference at float32 over the whole batch, from the same raw key
    material."""

    def __init__(self, p: dict, keys: dict, setup: dict, unit):
        self.ref = reference_for(p, keys, torch.float32)
        self.unit = unit
        self.key_tensors = list(keys.values())
        self.form = "control: the reference in float32"

    @property
    def key_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.key_tensors)

    @staticmethod
    def wrap(a, b):
        return a, b

    def gate(self, x, y):
        return self.unit.reference(self.ref, *x, *y)

    @staticmethod
    def words(sample):
        return sample


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = Manifest.load()
    for seed in args.seeds:
        res = run_cell(args.workload, seed, args.seconds, False, "cuda",
                       manifest, program=ControlProgram)
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"], "attempted": res["attempted"],
                "checks": res["checks"]}
        log(json.dumps(line))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
