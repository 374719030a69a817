"""The port's spans and counters (`tfhe_tpu_torch.instrument`), on the CPU
at toy parameters.

* a gate under torch.profiler: the spans `tfhe.gate` > (`tfhe.modswitch`,
  `tfhe.rotation`, `tfhe.extract`, `tfhe.keyswitch`), in that order, as
  the Chrome trace that the benchmark reads holds them;
* with no profiler running, no `record_function` is entered;
* the counters through `ops.reset_launches()` / `ops.launches()`, as the
  benchmark's harness calls them; `path.<form>` one a rotation; `built.*`
  only on a cache miss.
"""

import json

import pytest
import torch

import tfhe_tpu_torch as tp
from tfhe_tpu_torch import instrument, ops, tuning
from tfhe_tpu_torch import mk as p_mk
from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

torch.set_num_threads(2)

STAGES = ["tfhe.modswitch", "tfhe.rotation", "tfhe.extract",
          "tfhe.keyswitch"]


@pytest.fixture(scope="module")
def single():
    g = torch.Generator().manual_seed(16)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    x, y, z = (tp.encrypt(g, sk, torch.tensor([v, not v]))
               for v in (True, True, False))

    def gate():
        return tp.gate_nand(ck, x, y)

    gate.mux = lambda: tp.gate_mux(ck, x, y, z)
    gate.decrypt = lambda out: tp.decrypt(sk, out)
    return gate


@pytest.fixture(scope="module")
def multi():
    g = torch.Generator().manual_seed(17)
    params = p_mk.mktfhe_parameters_toy(2)
    shared = p_mk.make_shared_key(g, params)
    sks = [tp.make_secret_key(g, params) for _ in range(2)]
    ck = p_mk.make_mk_cloud_key(
        [p_mk.make_cloud_key_part(g, sk, shared) for sk in sks])
    x, y = (p_mk.mk_encrypt(g, sks, torch.tensor([v, not v]))
            for v in (True, True))

    def gate():
        return p_mk.mk_gate_nand(ck, x, y)

    gate.decrypt = lambda out: p_mk.mk_decrypt(sks, out)
    return gate


def traced_spans(fn, tmp_path) -> list:
    """(name, start, end) of the `tfhe.*` spans of one call of `fn`, from
    the Chrome trace torch.profiler writes (the events the benchmark's
    `TraceView` reads), in order of start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("tfhe.")),
                  key=lambda s: (s[1], -s[2]))


def check_stages(spans, stages):
    """One `tfhe.gate` span holding `stages`, in order, one after another."""
    (name, g0, g1), rest = spans[0], spans[1:]
    assert name == "tfhe.gate"
    assert [s[0] for s in rest] == stages
    assert all(g0 <= s0 <= s1 <= g1 for _, s0, s1 in rest)
    assert all(a[2] <= b[1] for a, b in zip(rest, rest[1:]))


@pytest.mark.parametrize("which", ["single", "multi"])
def test_gate_stages_nest_in_order(which, request, tmp_path):
    gate = request.getfixturevalue(which)
    out = None

    def call():
        nonlocal out
        out = gate()

    check_stages(traced_spans(call, tmp_path), STAGES)
    assert gate.decrypt(out).tolist() == [False, True]


def test_mux_is_one_gate_span_around_two_rotations(single, tmp_path):
    wrappers = ops.reset_launches()
    spans = traced_spans(single.mux, tmp_path)
    check_stages(spans, STAGES[:3] * 2 + STAGES[3:])
    assert ops.launches(wrappers) == {"path.baked": 2}


def test_no_record_function_without_a_profiler(single, multi, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not instrument.recording()
    assert single.decrypt(single()).tolist() == [False, True]
    assert multi.decrypt(multi()).tolist() == [False, True]
    assert single.decrypt(single.mux()).tolist() == [True, True]
    with instrument.span("tfhe.gate"):
        pass


def test_launch_counters_round_trip_as_the_harness_reads_them(single):
    wrappers = ops.reset_launches()  # benchmark/system.py:reset_launches
    assert wrappers == ops.kernel_wrappers() and ops.launches(wrappers) == {}
    single()
    instrument.count("blind_rotate")
    instrument.count("rotate_decompose_rows", 630)
    assert ops.launches(wrappers) == {  # benchmark/system.py:read_launches
        "path.baked": 1, "blind_rotate": 1, "rotate_decompose_rows": 630}
    assert instrument.counts(wrappers) == {  # the launches alone
        "blind_rotate": 1, "rotate_decompose_rows": 630}
    some = {"blind_rotate": wrappers["blind_rotate"]}
    assert ops.launches(some) == {"path.baked": 1, "blind_rotate": 1}
    ops.reset_launches()
    assert ops.launches(wrappers) == {} and instrument.counts() == {}


@pytest.mark.parametrize("form,knobs", [
    ("baked", {}),
    ("dense", {"karatsuba_depth": 0}),
    ("compact", {"bs_bake_budget": 0}),
    ("plain", {"bs_bake_budget": 0, "karatsuba_depth": 0}),
    ("mk_plain", None),
])
def test_path_counts_one_a_rotation(form, knobs, multi):
    if knobs is None:
        gate, gates = multi, 2
    else:
        g = torch.Generator().manual_seed(18)
        with tuning.override(**knobs):
            sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
        x, y = (tp.encrypt(g, sk, torch.tensor([v])) for v in (True, False))

        def gate():
            return tp.gate_nand(ck, x, y)
        gates = 2
    wrappers = ops.reset_launches()
    for _ in range(gates):
        gate()
    counts = ops.launches(wrappers)
    assert {k: v for k, v in counts.items() if k.startswith("path.")} == \
        {f"path.{form}": gates}


def test_a_second_gate_builds_nothing(single, multi):
    karatsuba_plan.cache_clear()
    ops.reset_launches()
    single()
    assert instrument.counts() == {"path.baked": 1,
                                   "built.karatsuba_plan": 1}
    assert set(instrument.seconds()) == {"built.karatsuba_plan"}
    assert set(ops.build_seconds()) == {"built.karatsuba_plan"}
    for gate in (single, multi, single):
        ops.reset_launches()
        gate()
        assert not [k for k in instrument.counts() if k.startswith("built.")]
        assert instrument.seconds() == {}


def test_cached_build_counts_and_times_misses_only():
    calls = []

    @instrument.cached_build("toy_table")
    def toy_table(n):
        calls.append(n)
        if n < 0:
            raise ValueError("negative")
        return tuple(range(n))

    ops.reset_launches()
    assert toy_table(3) == (0, 1, 2) and toy_table(3) == (0, 1, 2)
    toy_table(4)
    with pytest.raises(ValueError):
        toy_table(-1)
    assert calls == [3, 4, -1]
    assert instrument.counts() == {"built.toy_table": 3}
    assert instrument.seconds()["built.toy_table"] > 0
    assert toy_table.__name__ == "toy_table"
    assert toy_table.cache_info().hits == 1
