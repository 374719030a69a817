"""A unit of work added as files alone: `data/units/add4.py`, a one-digit
programmable-bootstrap add, with its configuration and workloads under
`data/`, runs through `run_cell` with no edit of the harness's core. A
sound run is correct in both loops; the float32 control and the broken
programs are not. The reference's general bootstrap equals the port's
lookup-table bootstraps, the many-LUT one included."""

from __future__ import annotations

import pytest
import torch

from benchmark import inputs, system
from benchmark.control import ControlProgram
from benchmark.reference import tfhe as ref
from benchmark.run import BENCH, load_json, load_unit
from benchmark.tests.helpers import DATA, NAND, run_toy
from benchmark.tests.test_bench_faults import AlteredAnswer, FlippedAnswer

CELLS = ("pbs_toy.add4_b8", "pbs_toy.add4_b1")


def test_a_unit_is_found_in_the_cell_directory_first():
    assert not (BENCH / "units" / "add4.py").exists()
    add4 = load_unit("add4", DATA)
    assert add4.__file__ == str(DATA / "units" / "add4.py")
    assert load_unit("nand", DATA).__file__ == str(BENCH / "units" /
                                                   "nand.py")
    with pytest.raises(FileNotFoundError):
        load_unit("add4")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_toy(cell)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["mismatched_gates"]["value"] == 0
    assert res["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("program", [ControlProgram, AlteredAnswer,
                                     FlippedAnswer])
def test_control_and_broken_programs_are_not_correct(cell, program):
    res = run_toy(cell, program=program, seconds=0.05)
    assert not res["correct"]
    assert res["checks"]["mismatched_gates"]["value"] > 0


def _keys_and_program(unit):
    torch.set_num_threads(2)
    p = load_json("configs", "pbs_toy", DATA)
    gen = torch.Generator().manual_seed(2**31 + 8)
    keys = inputs.draw_keys(p, gen)
    system.use_tuning(p)
    return p, keys, gen, system.System(p, keys, {}, unit)


def test_reference_bootstrap_equals_the_port_lut():
    add4 = load_unit("add4", DATA)
    p, keys, gen, prog = _keys_and_program(add4)
    x_m, y_m = (add4.draw(gen, (6,)) for _ in range(2))
    x = inputs.encrypt(p, keys, add4.phase(x_m), gen)
    y = inputs.encrypt(p, keys, add4.phase(y_m), gen)
    out = prog.words(prog.gate(prog.wrap(*x), prog.wrap(*y)))
    want = add4.reference(ref.reference_for(p, keys), *x, *y)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    got = add4.decrypt(inputs.phase(p, keys, *want))
    assert torch.equal(got, add4.apply(x_m, y_m))


def test_reference_many_lut_equals_the_port():
    """q = 2 tables from one rotation: the 2N/q modulus switch and the
    extraction of coefficients 0 and 1."""
    from tfhe_tpu_torch.pbs import programmable_bootstrap_many

    p, keys, gen, prog = _keys_and_program(NAND)
    space, q = 8, 2
    n_poly = p["tlwe_polynomial_degree"]
    w = n_poly // space
    tables = torch.tensor([[m % 4 for m in range(space)],
                           [m // 4 for m in range(space)]])
    m = torch.randint(0, space - 1, (5,), generator=gen)
    x = inputs.encrypt(p, keys, (m << 28).to(torch.int32), gen)
    ck = prog.ck
    out = programmable_bootstrap_many(ck.bootstrap_key, ck.keyswitch_key,
                                      tables, prog.wrap(*x), space, q)
    enc = (tables << 28).to(torch.int32)  # [q, S]
    test = enc[torch.arange(w) % q].T.reshape(n_poly)  # v[m*w + r]
    want_a, want_b = ref.reference_for(p, keys).bootstrap(
        *x, test.expand(5, n_poly), barb_offset=w // 2, q=q)
    assert want_a.shape == (5, q, p["lwe_size"]) and want_b.shape == (5, q)
    assert torch.equal(out.a, want_a) and torch.equal(out.b, want_b)
    got = inputs.phase(p, keys, want_a, want_b)
    assert torch.equal((got.to(torch.int64) + (1 << 27)) >> 28,
                       tables[:, m].T)
