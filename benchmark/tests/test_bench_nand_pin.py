"""The NAND cells bit for bit: a digest of each toy NAND cell's drawn
inputs (every ciphertext handed to the program), the words of every gate
the program ran, the gates handed to the reference and the compared
numbers, at the helpers' seed. A traced run of no window runs a fixed
number of units (the traced stretch and one timed unit), so the digest
does not depend on the CPU's speed. `data/nand_digest.json` holds the
digests that the harness gave before the unit of work became a file."""

from __future__ import annotations

import hashlib
import json

import pytest

from benchmark import system
from benchmark.reference import tfhe as ref
from benchmark.tests.helpers import DATA, run_toy

CELLS = ("toy.nand_b8", "toy.nand_b1", "mk_toy.nand_b1",
         "fast128_toy.nand_b8")


def nand_digest(cell: str, monkeypatch) -> str:
    h = hashlib.sha256()

    def feed(*tensors):
        for t in tensors:
            t = t.detach().cpu().contiguous()
            h.update(f"{t.dtype} {tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())

    class Recording(system.System):
        def wrap(self, a, b):
            feed(a, b)
            return super().wrap(a, b)

        def gate(self, x, y):
            out = super().gate(x, y)
            feed(*self.words(x), *self.words(y), *self.words(out))
            return out

    for cls in (ref.CggiReference, ref.MkReference):
        def nand(self, x_a, x_b, y_a, y_b, _nand=cls.nand):
            feed(x_a, x_b, y_a, y_b)
            return _nand(self, x_a, x_b, y_a, y_b)

        monkeypatch.setattr(cls, "nand", nand)
    res = run_toy(cell, program=Recording, seconds=0.0, trace=True)
    h.update(json.dumps({k: res[k] for k in ("correct", "attempted",
                                              "failed", "checks")},
                        sort_keys=True).encode())
    return h.hexdigest()


@pytest.mark.parametrize("cell", CELLS)
def test_nand_reproduces_its_digest(cell, monkeypatch):
    with open(DATA / "nand_digest.json") as f:
        want = json.load(f)[cell]
    assert nand_digest(cell, monkeypatch) == want
