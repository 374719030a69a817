"""The plain reference against the port, and the frozen counts against the
port's product tables, from outside both: the reference equals the port's
gate bootstrap word for word at toy sizes on the CPU, and the roofline's
operation count is no more than the work the port's plan does."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import counts, inputs, stats, system
from benchmark.reference import tfhe as ref
from benchmark.tests.helpers import DATA, NAND
from spec import oracle


def _config(name):
    with open(DATA / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["toy", "toy_k2", "mk_toy"])
def test_reference_equals_the_port_gate(name):
    """NAND through the port's key (made from the raw material) and the
    reference's, on fresh ciphertexts: equal words, right bits."""
    torch.set_num_threads(2)
    p = _config(name)
    gen = torch.Generator().manual_seed(2**31 + 17)
    keys = inputs.draw_keys(p, gen)
    system.use_tuning(p)
    prog = system.System(p, keys, {}, NAND)
    bits = torch.randint(0, 2, (2, 6), generator=gen).bool()
    x = inputs.encrypt(p, keys, NAND.phase(bits[0]), gen)
    y = inputs.encrypt(p, keys, NAND.phase(bits[1]), gen)
    out_a, out_b = prog.words(prog.gate(prog.wrap(*x), prog.wrap(*y)))
    want_a, want_b = ref.reference_for(p, keys).nand(*x, *y)
    assert torch.equal(out_a, want_a) and torch.equal(out_b, want_b)
    assert torch.equal(NAND.decrypt(inputs.phase(p, keys, want_a, want_b)),
                       ~(bits[0] & bits[1]))


def test_negacyclic_product_equals_the_spec():
    gen = torch.Generator().manual_seed(5)
    d = torch.randint(-64, 64, (3, 64), generator=gen)
    k = torch.randint(-(2**31), 2**31, (3, 2, 64), dtype=torch.int32,
                      generator=gen)
    got = ref.poly_mul(d.unsqueeze(0), k, torch.float64)[0]
    for c in range(2):
        want = sum(oracle.negacyclic_mul(d[r].numpy(), k[r, c].numpy())
                   .astype(np.int64) for r in range(3))
        assert np.array_equal(got[c].numpy(), oracle.w32(want))


def test_decompose_and_keyswitch_digits_equal_the_spec():
    gen = torch.Generator().manual_seed(6)
    words = torch.randint(-(2**31), 2**31, (40,), dtype=torch.int32,
                          generator=gen)
    for balanced in (False, True):
        want = oracle.decompose(words.numpy(), 3, 7, balanced)
        assert np.array_equal(ref.decompose(words, 3, 7, balanced).numpy(),
                              want)
    assert np.array_equal(ref.mod_switch(words, 2048).numpy(),
                          oracle.decode_message(words.numpy(), 2048))


def test_float32_is_not_exact():
    """The control's precision cannot hold these products."""
    gen = torch.Generator().manual_seed(7)
    d = torch.randint(-64, 64, (4, 3, 256), generator=gen)
    k = torch.randint(-(2**31), 2**31, (3, 2, 256), dtype=torch.int32,
                      generator=gen)
    assert not torch.equal(ref.poly_mul(d, k, torch.float32),
                           ref.poly_mul(d, k, torch.float64))


def test_frozen_counts_equal_the_port_plan_and_undercut_its_tables():
    from tfhe_tpu_torch.ops.blind_rotate import product_tables
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    for b in (6, 7, 8):
        for m in (1, 2, 4, 8):
            for d in range(m.bit_length()):
                assert counts.superblock_products(m, d, b) == \
                    karatsuba_plan(m, d, b).macs_superblocks
    # the 128 preset: m = 8, b = 7, P = K*l = 6
    tables = product_tables(karatsuba_plan(8, 2, 7), 6, 128)
    port = sum(entry[2] for entry in tables)
    assert counts.fewest_superblocks(8, 7) == 34 < port == 40


def test_roofline_ops_undercut_the_port_counters():
    from tfhe_tpu_torch import params
    from tfhe_tpu_torch.utils.profiling import bootstrap_roofline

    with open(DATA.parent.parent / "configs" / "cggi128.json") as f:
        p = json.load(f)
    ops, key_bytes = counts.rotation_work(p, 4096)
    port = bootstrap_roofline(params.tfhe_parameters_128(), 4096, depth=2)
    assert ops <= 2 * port.byte_macs
    assert ops == 2 * 4096 * 630 * 34 * 768 * 1024
    assert key_bytes == 630 * 6 * 2 * 1024 * 4


def test_mk_active_blocks_equal_the_port_triangular_plan():
    from tfhe_tpu_torch.mk.internals import active_plan

    for parties in (2, 4, 8):
        for q in range(parties):
            assert counts.mk_active_blocks(q, parties) == \
                len(active_plan(q, parties, True)[1])


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.rate(4096 * 10, 2.0) == 20480.0
