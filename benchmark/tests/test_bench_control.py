"""The control (the reference in float32 in the program's place) comes out
not correct, and the exact float64 reference agrees with the port: the
comparison separates the two, at a size a test run holds."""

from __future__ import annotations

import pytest

from benchmark.control import ControlProgram
from benchmark.tests.helpers import run_toy


@pytest.mark.parametrize("cell", ["toy.nand_b8", "toy.nand_b1",
                                  "mk_toy.nand_b8"])
def test_control_is_not_correct(cell):
    res = run_toy(cell, program=ControlProgram, seconds=0.05)
    assert not res["correct"]
    assert res["checks"]["mismatched_gates"]["value"] > 0
