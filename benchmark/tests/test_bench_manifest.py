"""`BENCHMARK.json` against its contract, the harness's files found by
name, and the import rules: nothing of the harness imports JAX or the JAX
package (top-level names compared whole: `tfhe_tpu_torch` is not
`tfhe_tpu`), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import BENCH, ROOT, Manifest, load_json, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_tpu"}
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_and_paths(bench):
    assert list(bench) == TOP_KEYS
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [e["name"] for e in bench[kind]]
        assert len(set(kind_names)) == len(kind_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([e["why"] for e in bench["configs"] + bench["workloads"]]
                 + [m["layer"] for m in bench["per_layer"]]
                 + [c["source"] for c in bench["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys_bounds_and_sources(bench):
    for c in bench["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
    for w in bench["workloads"]:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_files_are_found_by_name(bench):
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.parent == BENCH / "configs" and path.stem == c["name"]
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert load_json("workloads", w["name"])["config"] == w["config"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_reader(m["name"]).read)


def test_every_cell_reports_what_its_metrics_move(bench):
    man = Manifest(bench)
    for cell in man.cells:
        e2e = {m["name"] for m in man.metrics(cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics(cell, True)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", man.cells):
            assert cell in man.cells
            assert cell in moved.get("workloads", [cell])
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"`{layer}`" in perf for layer in layers)


def test_a_cell_added_as_files_alone_is_found(bench, tmp_path):
    """A later cell brings a workload file and a manifest entry, and the
    harness finds both by name without an edit."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH / "configs", root / "configs")
    shutil.copytree(BENCH / "workloads", root / "workloads")
    new = dict(load_json("workloads", "cggi128.nand_b4096"), batch=512)
    (root / "workloads" / "cggi128.nand_b512.json").write_text(
        json.dumps(new))
    data = json.loads(json.dumps(bench))
    data["workloads"].append({"name": "cggi128.nand_b512",
                              "config": "cggi128", "traffic": "nand_b512",
                              "chips": 1, "why": "a later cell"})
    data["end_to_end"][0]["workloads"].append("cggi128.nand_b512")
    man = Manifest(data)
    assert load_json("workloads", "cggi128.nand_b512", root)["batch"] == 512
    assert {m["name"] for m in man.metrics("cggi128.nand_b512", False)} == \
        {"gates_per_s", "device_mem_gib", "setup_s"}
    assert "key_gib" in {m["name"]
                         for m in man.metrics("cggi128.nand_b512", True)}


def _imports(path: Path, top_only: bool) -> set:
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_only else list(ast.walk(tree))
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path, top_only=True) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path, top_only=False)
        assert not names & (FORBIDDEN | {"tfhe_tpu_torch"}), path


def test_the_harness_loads_no_jax_and_refuses_to_run_without_a_card():
    code = ("import sys, benchmark.run, benchmark.system, benchmark.control; "
            "sys.exit(3 if {m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r}) else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode \
        == 0
    run = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "cggi128.nand_b1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin"})
    assert run.returncode != 0 and run.stdout == ""
