"""The port's run entry points on the CPU, at toy sizes (`--device cpu`):
`tfhe_tpu_torch.bench`, `bench_suite`, `tools.security_estimate`,
`tools.serving_bench`, `tools.batch_job` and `examples.tutorial`.

* The bench line has exactly the reference `bench.py`'s eight keys.
* Each suite section emits the reference `bench_suite.py`'s metric names
  (mk8 is left out here: its toy ceremony alone takes ~30 s on the CPU).
* The orchestrator prints `section_<name>` and exits 1 for a failed
  section (its one subprocess finds no such section).
* `estimate_preset` equals the reference `tools/security_estimate.py`'s
  (loaded by path) for every preset, to the last bit.
* Without a card, an entry point not asked for the CPU exits non-zero.
* The batch job, preempted after its first checkpoint, resumes from it
  when run again with the same arguments (in-process: its hard exit is
  monkeypatched into SystemExit).
"""

import importlib
import importlib.util
import json
import os
import sys

import pytest
import torch

from tfhe_tpu_torch import bench, bench_suite
from tfhe_tpu_torch.examples import tutorial
from tfhe_tpu_torch.tools import batch_job, security_estimate, serving_bench

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]

# bench.py's result line (bench.py:161-170)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "params",
              "security_core_svp_bits", "correct", "of"]
# bench_suite.py's metric names, section by section
SUITE_METRICS = {
    "80bit": ["single_nand_latency_80bit",
              "chained_nand_device_latency_80bit",
              "single_nand_latency_compact_key", "gate_set_correct"],
    "128core": ["batched_nand_throughput_128bit",
                "pbs_lut4_throughput_128bit", "adder8_words_per_sec",
                "radix_adder8_words_per_sec"],
    "fast": ["batched_nand_throughput_128fast"],
    "fast8": ["batched_nand_throughput_128fast8"],
    "radix_preset": ["radix_adder8_words_per_sec_radix_preset"],
    "radix_reliable": ["radix_adder8_words_per_sec_reliable"],
    "mk2": ["mk2_nand_throughput"],
    "mk2_ref": ["mk2_nand_throughput_reference_preset"],
    "mk4": ["mk4_nand_throughput"],
    "mk8": ["mk8_nand_throughput"],
}
ENTRY_POINTS = ["bench", "bench_suite", "tools.serving_bench",
                "tools.batch_job", "examples.tutorial", "examples.pbs_lut",
                "examples.radix_arithmetic", "examples.multikey",
                "examples.wire_format", "examples.multitenant"]


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_pinned_names_are_the_references():
    with open(os.path.join(REPO, "bench.py")) as f:
        ref_bench = f.read()
    with open(os.path.join(REPO, "bench_suite.py")) as f:
        ref_suite = f.read()
    for key in BENCH_KEYS:
        assert f'"{key}":' in ref_bench, key
    for names in SUITE_METRICS.values():
        for name in names:
            assert f'"{name}"' in ref_suite, name
    assert list(SUITE_METRICS) == list(bench_suite.SECTIONS)


def test_bench_line_has_the_reference_keys(monkeypatch, capsys):
    monkeypatch.setenv("TFHE_TPU_BENCH_PARAMS", "toy")
    monkeypatch.setenv("TFHE_TPU_BENCH_BATCH", "8")
    monkeypatch.setenv("TFHE_TPU_BENCH_ITERS", "2")
    assert bench.main(CPU) == 0
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert list(rec) == BENCH_KEYS
    assert rec["metric"] == "nand_bootstraps_per_sec_128bit"
    assert rec["params"] == "toy" and rec["vs_baseline"] is None
    assert rec["correct"] == rec["of"] == 8
    assert rec["value"] > 0 and rec["security_core_svp_bits"] > 0
    assert "device=cpu" in out.err
    assert "builds through the first call, host s: {" in out.err


@pytest.mark.parametrize("section", [s for s in SUITE_METRICS if s != "mk8"])
def test_suite_section_emits_reference_metrics(section, capsys):
    bench_suite.SECTIONS[section](
        bench_suite.Run(torch.device("cpu"), small=True))
    recs = json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in recs] == SUITE_METRICS[section]
    for r in recs:
        assert r["small_toy_params"] is True
        assert r.get("errors", 0) == 0
        assert r.get("correct") == r.get("of")
        if r["metric"] == "gate_set_correct":
            assert r["value"] == 10


def test_suite_orchestrator_reports_a_failed_section(monkeypatch, capsys):
    monkeypatch.delenv("TFHE_SUITE_SECTIONS", raising=False)
    # its subprocess for "no_such_section" finds no such section, exits 1
    monkeypatch.setattr(bench_suite, "SECTIONS", {"no_such_section": None})
    assert bench_suite.main(CPU) == 1
    recs = json_lines(capsys.readouterr().out)
    assert recs == [{"metric": "section_no_such_section", "value": -1,
                     "unit": "failed", "exit_code": "1"}]


def test_suite_refuses_an_unknown_section(monkeypatch):
    monkeypatch.setenv("TFHE_SUITE_SECTIONS", "fast,no_such_section")
    with pytest.raises(SystemExit) as e:
        bench_suite.main(CPU)
    assert "no_such_section" in str(e.value.code)


def _reference_estimator():
    name = "reference_security_estimate"
    if name not in sys.modules:  # its dataclass needs its module registered
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "tools", "security_estimate.py"))
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


@pytest.mark.parametrize("preset", list(security_estimate.shipped_presets()))
def test_estimate_preset_matches_reference(preset):
    ref = _reference_estimator()
    ref_params = ref.shipped_presets()[preset]
    port_params = security_estimate.shipped_presets()[preset]
    assert port_params.lwe_size == ref_params.lwe_size
    for quantum in (False, True):
        assert security_estimate.estimate_preset(port_params, quantum) == \
            ref.estimate_preset(ref_params, quantum)
    assert list(security_estimate.shipped_presets()) == \
        list(ref.shipped_presets())


def test_entry_points_refuse_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ENTRY_POINTS:
        mod = importlib.import_module(f"tfhe_tpu_torch.{name}")
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code not in (0, None), name
        assert "--device cpu" in str(e.value.code), name


def test_serving_sweep_lines(monkeypatch, capsys):
    monkeypatch.setenv("TFHE_TPU_SERVE_SMALL", "1")
    monkeypatch.setenv("TFHE_TPU_SERVE_PRESETS", "128fast8")
    assert serving_bench.main(CPU) == 0
    recs = json_lines(capsys.readouterr().out)
    assert [(r["preset"], r["form"], r["batch"]) for r in recs] == [
        ("128fast8", "compact", 1), ("128fast8", "compact", 2)]
    for r in recs:
        assert list(r)[:6] == ["preset", "form", "batch", "key_mb",
                               "ms_per_layer", "gates_per_sec"]
        assert r["correct"] == r["of"] == r["batch"]


def test_tutorial_example(capsys):
    assert tutorial.main(CPU) == 0
    assert "min(2017, 42) = 42" in capsys.readouterr().out


def test_batch_job_preempts_and_resumes(tmp_path, monkeypatch, capsys):
    def preempted(code):  # the job's hard exit, as an exception here
        raise SystemExit(code)

    monkeypatch.setattr(batch_job.os, "_exit", preempted)
    ckpt = str(tmp_path / "job.ckpt")
    argv = [*CPU, "--params", "toy", "--bits", "4", "--batch", "8",
            "--ckpt", ckpt, "--preempt-after", "1"]
    with pytest.raises(SystemExit) as e:
        batch_job.main(argv)
    assert e.value.code == batch_job.PREEMPTED
    assert "simulated preemption" in capsys.readouterr().out
    assert os.path.exists(ckpt)
    assert batch_job.main(argv) == 0  # the same arguments again
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("resuming at batch 2/")
    assert lines[-1].endswith(": 8/8 sums correct")
    assert not os.path.exists(ckpt)
