"""What the benchmark's CPU tests share: the toy cells under `data/`."""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark.run import Manifest, load_unit, run_cell

DATA = Path(__file__).resolve().parent / "data"
SEED = 2**31 + 4242  # past 32 signed bits, as a check's seeds may be
NO_METRICS = Manifest({"workloads": [], "end_to_end": [], "per_layer": []})
NAND = load_unit("nand")


def run_toy(cell: str, program=None, seconds: float = 0.2,
            seed: int = SEED, trace: bool = False,
            manifest: Manifest = NO_METRICS) -> dict:
    """One run of a toy cell on the CPU: the whole run but the look for
    a card."""
    torch.set_num_threads(2)
    return run_cell(cell, seed, seconds, trace, "cpu", manifest, bench=DATA,
                    program=program)
