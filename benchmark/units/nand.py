"""The NAND gate, the unit of work of the `nand_*` cells: a row is one
bit, encrypted as +-1/8, and a unit runs NAND(x, y) over the batch, one
gate bootstrap (one blind rotation) a row; single-key (`gates.gate_nand`)
or multi-key (`mk.gates.mk_gate_nand`). The contract of a unit file is in
`benchmark/run.py:load_unit`."""

from __future__ import annotations

import torch

MU = 1 << 29  # 1/8 on the torus


def draw(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen).bool()


def phase(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits, MU, -MU).to(torch.int32)


def apply(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ~(x & y)


def decrypt(phase: torch.Tensor) -> torch.Tensor:
    return phase > 0


def program(scheme: str):
    """The port's gate, called as f(cloud key, x, y)."""
    if scheme == "cggi":
        from tfhe_tpu_torch.gates import gate_nand

        return gate_nand
    from tfhe_tpu_torch.mk.gates import mk_gate_nand

    return mk_gate_nand


def reference(ref, x_a, x_b, y_a, y_b):
    return ref.nand(x_a, x_b, y_a, y_b)


def rotations_per_row(p: dict) -> int:
    return 1
