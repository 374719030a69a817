"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the sound run comes out correct. On the
CPU at toy sizes, everything of a run but the look for a card."""

from __future__ import annotations

import pytest

from benchmark import system
from benchmark.tests.helpers import run_toy

CELLS = ("toy.nand_b8", "toy.nand_b1", "toy_k2.nand_b8", "mk_toy.nand_b8",
         "mk_toy.nand_b1")


class HalfBatch(system.System):
    """Half of the batch left out: the gate runs on the first half and
    hands its outputs out twice."""

    def gate(self, x, y):
        half = x.b.shape[0] // 2
        out = super().gate(type(x)(*(t[:half] for t in x)),
                           type(y)(*(t[:half] for t in y)))
        return type(out)(*(t.repeat((2,) + (1,) * (t.dim() - 1))
                           for t in out))


class AlteredAnswer(system.System):
    """Every output's body one word off, where the gate produces it."""

    def gate(self, x, y):
        out = super().gate(x, y)
        return out._replace(b=out.b + 1)


class FlippedAnswer(system.System):
    """One output of every unit negated: it decrypts to the other bit."""

    def gate(self, x, y):
        out = super().gate(x, y)
        a, b = out.a.clone(), out.b.clone()
        a[0], b[0] = -a[0], -b[0]
        return out._replace(a=a, b=b)


def _unchanged(accum, *args, **kwargs):
    return accum


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_toy(cell)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["mismatched_gates"]["value"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_rotation_step_returning_its_state(cell, monkeypatch):
    """Each CMUX step returns the accumulator unchanged: the rotation is
    the identity."""
    import tfhe_tpu_torch.bootstrap as bootstrap
    import tfhe_tpu_torch.mk.internals as internals

    monkeypatch.setattr(bootstrap, "blind_rotate", _unchanged)
    monkeypatch.setattr(internals, "mk_blind_rotate", _unchanged)
    res = run_toy(cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_gates"]["value"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if "b8" in c])
def test_half_of_the_batch_left_out(cell):
    res = run_toy(cell, program=HalfBatch)
    assert not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [AlteredAnswer, FlippedAnswer])
def test_answer_altered_where_produced(cell, fault):
    res = run_toy(cell, program=fault)
    assert not res["correct"]
