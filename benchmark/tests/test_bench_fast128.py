"""The `fast128` configuration and its cell: the configuration is the
port's `tfhe_parameters_128_fast`; at its geometry (k=4, N=256, balanced
l=2 b=8, keyswitch l=8 b=2) on a toy LWE size the port's gate equals the
reference word for word, a run is correct, the control and a broken
program are not; the frozen count at M=2 agrees with the port's plan; the
reader of `dots_blocks_per_sm.b4096`; the manifest finds the cell."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from benchmark import counts, inputs, system
from benchmark.control import ControlProgram
from benchmark.reference import tfhe as ref
from benchmark.run import Manifest, load_json, load_reader
from benchmark.tests.helpers import DATA, NAND, run_toy
from benchmark.tests.test_bench_faults import AlteredAnswer, FlippedAnswer

CELL = "fast128.nand_b4096"
TOY = "fast128_toy.nand_b8"


def _toy_config():
    return load_json("configs", "fast128_toy", DATA)


def test_the_configuration_is_the_port_preset():
    from tfhe_tpu_torch.params import tfhe_parameters_128_fast

    p = load_json("configs", "fast128")
    want = dataclasses.asdict(tfhe_parameters_128_fast())
    assert {k: p[k] for k in want} == want
    assert p["scheme"] == "cggi" and p["tuning"] == {} and p["reduced"] == []
    toy = _toy_config()
    assert {k: toy[k] for k in want if k != "lwe_size"} == \
        {k: v for k, v in want.items() if k != "lwe_size"}


def test_reference_equals_the_port_gate_at_the_geometry():
    """NAND through the port's baked key (depth 2 clamped to 1: three plan
    rows at M=2) and the reference's, on fresh ciphertexts."""
    torch.set_num_threads(2)
    p = _toy_config()
    gen = torch.Generator().manual_seed(2**31 + 128)
    keys = inputs.draw_keys(p, gen)
    system.use_tuning(p)
    prog = system.System(p, keys, {}, NAND)
    bk = prog.ck.bootstrap_key
    assert bk.depth == 1 and bk.plan.total_rows == 3
    assert tuple(bk.baked.shape) == (p["lwe_size"], 3 * 10 * 128, 5 * 4 * 128)
    bits = torch.randint(0, 2, (2, 6), generator=gen).bool()
    x = inputs.encrypt(p, keys, NAND.phase(bits[0]), gen)
    y = inputs.encrypt(p, keys, NAND.phase(bits[1]), gen)
    out_a, out_b = prog.words(prog.gate(prog.wrap(*x), prog.wrap(*y)))
    want_a, want_b = ref.reference_for(p, keys).nand(*x, *y)
    assert torch.equal(out_a, want_a) and torch.equal(out_b, want_b)
    assert torch.equal(NAND.decrypt(inputs.phase(p, keys, want_a, want_b)),
                       ~(bits[0] & bits[1]))


@pytest.mark.parametrize("program,correct", [
    (None, True), (ControlProgram, False), (AlteredAnswer, False),
    (FlippedAnswer, False)])
def test_a_run_is_correct_and_a_wrong_one_is_not(program, correct):
    res = run_toy(TOY, program=program, seconds=0.05)
    assert res["correct"] is correct
    if correct:
        assert res["failed"] == 0
        assert res["checks"]["mismatched_gates"]["value"] == 0
    else:
        assert res["checks"]["mismatched_gates"]["value"] > 0


def test_fewest_count_at_m2_agrees_with_the_port_plan():
    from tfhe_tpu_torch.ops.blind_rotate import product_tables
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    assert counts.fewest_superblocks(2, 8) == 4
    for depth in (0, 1):
        assert counts.superblock_products(2, depth, 8) == 4 == \
            karatsuba_plan(2, depth, 8).macs_superblocks
    tables = product_tables(karatsuba_plan(2, 1, 8), 10, 128)
    assert sum(entry[2] for entry in tables) >= 4
    ops, key_bytes = counts.rotation_work(load_json("configs", "fast128"),
                                          4096)
    assert ops == 2 * 4096 * 630 * 4 * 10 * 20 * 128 * 128
    assert key_bytes == 630 * 10 * 5 * 256 * 4


def _launches(launches, loop="chained"):
    return types.SimpleNamespace(loop=loop, launches=launches)


@pytest.mark.parametrize("launches,loop,want", [
    ({"dots.per_sm.2": 1, "dots.clustered": 1, "blind_rotate": 1},
     "chained", 2.0),
    ({"dots.per_sm.1": 4, "dots.clustered": 4}, "chained", 1.0),
    ({"dots.per_sm.1": 1, "dots.per_sm.2": 3}, "chained", 1.75),
    ({"dots.clustered": 3, "path.baked": 3}, "chained", None),
    ({}, "chained", None),
    ({"dots.per_sm.1": 630}, "closed", None),
])
def test_blocks_per_sm_reader(launches, loop, want):
    got = load_reader("dots_blocks_per_sm.b4096").read(
        _launches(launches, loop))
    assert got == want


def test_the_manifest_finds_the_cell():
    man = Manifest.load()
    w = man.cells[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("fast128", "nand_b4096", 1)
    traffic = load_json("workloads", CELL)
    cggi = load_json("workloads", "cggi128.nand_b4096")
    assert traffic == dict(cggi, config="fast128", trace_units=8)
    assert {m["name"] for m in man.metrics(CELL, False)} == \
        {"gates_per_s", "device_mem_gib", "setup_s"}
    assert {m["name"] for m in man.metrics(CELL, True)} == {
        "key_gib", "rotation_ms_per_layer.b4096",
        "keyswitch_ms_per_layer.b4096", "dots_roofline_pct.b4096",
        "device_idle_pct.b4096", "dots_blocks_per_sm.b4096",
        "dots_row_tile.b4096"}
    for cell in ("cggi128.nand_b4096", "mk2.nand_b4096"):
        assert "dots_blocks_per_sm.b4096" in \
            {m["name"] for m in man.metrics(cell, True)}
