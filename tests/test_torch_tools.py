"""The last entry-point twins on the CPU, at toy sizes: `graft_entry`
(`entry()`, `dryrun_multichip`), `tools.profile_bootstrap`,
`tools.pbs_bench` and `tools.scaling_bench`.

* The fake cloud key has the shapes and dtypes of keygen's: the port's toy
  keygen, and the reference's keygen at 128_fast and 128 through
  `jax.eval_shape` (nothing allocated). The reference's own fake key is
  the dense depth-0 bake there; the port's follows keygen's depth.
* `entry()`'s NAND gives the reference `entry()`'s words, array-equal, on
  the reference's inputs (a zero key: the depth makes no difference).
* `dryrun_multichip`: the mesh rule, the batch and what `launch` is
  handed (monkeypatched: no ranks start; the fake rank 0 runs the
  unsharded gate and writes the output the caller decrypts).
* The three tools' lines, the trace file, and the scaling rank body in a
  one-rank gloo world in this process.
* Without a card, each entry point exits non-zero with a message.
* Every program of the reference has a twin or a stated reason.
"""

import glob
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tp
from tfhe_tpu_torch import graft_entry
from tfhe_tpu_torch.lwe import LweSample
from tfhe_tpu_torch.parallel import dryrun
from tfhe_tpu_torch.tools import pbs_bench, profile_bootstrap, scaling_bench
from tfhe_tpu_torch.utils import serialization as ser

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]

# Each program of the reference and its twin in the port.
TWINS = {
    "__graft_entry__.py": "graft_entry",
    "bench.py": "bench",
    "bench_suite.py": "bench_suite",
    "tools/batch_job.py": "tools.batch_job",
    "tools/pbs_bench.py": "tools.pbs_bench",
    "tools/profile_bootstrap.py": "tools.profile_bootstrap",
    "tools/scaling_bench.py": "tools.scaling_bench",
    "tools/security_estimate.py": "tools.security_estimate",
    "tools/serving_bench.py": "tools.serving_bench",
    **{f"examples/{name}.py": f"examples.{name}"
       for name in ("multikey", "multitenant", "pbs_lut", "radix_arithmetic",
                    "tutorial", "wire_format")},
}
# The programs left unported, each with its reason (ROADMAP.md queue 1).
NOT_PORTED = {
    "tools/mk_bench.py": "the suite's mk2, mk2_ref, mk4 and mk8 sections "
                         "run its ceremony and layer; MK_BENCH_SEGMENTS is "
                         "a TPU knob",
    "tools/kernel_microbench.py": "chip_smoke.py phase 3 and --rows-against "
                                  "time every kernel per step",
    "tools/engine_crosscheck.py": "phase 3 holds every kernel torch.equal "
                                  "to its plain version; tuning.debug",
    "tools/compact_crosscheck.py": "as engine_crosscheck.py",
    "tools/mk_noise_measure.py": "the port's words are the reference's; the "
                                 "suite counts the MK failures on the card",
    "tools/derive_fast_params.py": "the presets are copied and pinned equal "
                                   "by a test",
    "tools/generate_spec_vectors.py": "writes reference artifacts on no "
                                      "device",
    "tools/dump_reference_vectors.jl": "writes reference artifacts (Julia)",
    "tools/gen_api_docs.py": "writes the reference's API docs",
    "tools/dispatch_probe.py": "a TPU dispatch probe",
    "tools/barrier_probe.py": "a TPU barrier probe",
    "tools/aot_probe.py": "a TPU ahead-of-time compile probe",
    "tools/tile_sweep.py": "a sweep of the TPU tile knobs",
    "tools/pipe_bench.py": "the TPU pipelined-kernel knob",
    "tools/xla_cpu_crash_probe.sh": "an XLA:CPU compiler probe",
}
# Programs of the port with no reference counterpart.
PORT_OWN = {"chip_smoke.py": "the port's check on the card"}


def load_reference_entry():
    spec = importlib.util.spec_from_file_location(
        "_ref_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_key_shapes(params):
    """(baked shape, depth, keyswitch shape) of the reference's keygen, and
    of the reference's fake key, traced only."""
    import tfhe_tpu as tt

    ck = jax.eval_shape(lambda k: tt.make_key_pair(k, params)[1],
                        jax.random.PRNGKey(0))
    fake = jax.eval_shape(
        lambda: load_reference_entry()._fake_cloud_key(params, None))
    keygen = (ck.bootstrap_key.baked.shape, ck.bootstrap_key.depth,
              ck.keyswitch_key.table_limbs.shape)
    return keygen, (fake.bootstrap_key.baked.shape, fake.bootstrap_key.depth)


def test_fake_key_matches_a_toy_keygen():
    import tfhe_tpu as tt

    params = tp.tfhe_parameters_toy()
    fake = graft_entry._fake_cloud_key(params, torch.device("cpu"))
    _, real = tp.make_key_pair(torch.Generator().manual_seed(3), params)
    for got, want in ((fake.bootstrap_key.baked, real.bootstrap_key.baked),
                      (fake.keyswitch_key.table_limbs,
                       real.keyswitch_key.table_limbs)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert not got.any()
    fb, rb = fake.bootstrap_key, real.bootstrap_key
    assert (fb.depth, fb.block, fb.layout, fb.balanced) == \
        (rb.depth, rb.block, rb.layout, rb.balanced) == (1, 128, "reference",
                                                         False)
    fk, rk = fake.keyswitch_key, real.keyswitch_key
    assert (fk.n_in, fk.n_out, fk.decomp_length, fk.log2_base) == \
        (rk.n_in, rk.n_out, rk.decomp_length, rk.log2_base)
    keygen, _ = ref_key_shapes(tt.tfhe_parameters_toy())
    assert keygen == (tuple(rb.baked.shape), 1,
                      tuple(real.keyswitch_key.table_limbs.shape))


@pytest.mark.parametrize("preset", ["tfhe_parameters_128_fast",
                                    "tfhe_parameters_128"])
def test_fake_key_shapes_are_keygens(preset):
    import tfhe_tpu as tt

    shapes = graft_entry.fake_key_shapes(getattr(tp, preset)(), "cpu")
    keygen, ref_fake = ref_key_shapes(getattr(tt, preset)())
    assert (shapes["baked"], shapes["depth"], shapes["keyswitch"]) == keygen
    n, rows, cols = shapes["baked"]
    assert graft_entry.fake_key_shapes(getattr(tp, preset)(), "cuda")[
        "baked"] == (n, cols // (4 * 128), 4, 128, rows)  # K-major
    if preset == "tfhe_parameters_128_fast":
        # the reference's fake key: the dense depth-0 bake, not keygen's
        assert keygen[:2] == ((630, 3840, 2560), 1)
        assert ref_fake == ((630, 5120, 2560), 0)
    else:
        assert ref_fake == keygen[:2]


def test_entry_words_equal_the_references(monkeypatch):
    ref = load_reference_entry()
    ref_fn, (ref_ck, rx, ry) = ref.entry()
    want = jax.jit(ref_fn)(ref_ck, rx, ry)
    assert ref_ck.bootstrap_key.depth == 0

    fn, (ck, x, y) = graft_entry.entry("cpu")
    assert fn is tp.gate_nand and ck.bootstrap_key.depth == 1
    for s in (x, y):
        assert s.a.shape == (16, 16) and s.a.dtype == torch.int32
        assert s.b.shape == (16,) and not s.cv.any()

    def port(s):
        return LweSample(*(torch.from_numpy(np.array(f)) for f in s))

    got = fn(ck, port(rx), port(ry))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    monkeypatch.setenv("TFHE_ENTRY_BATCH", "5")
    assert graft_entry.entry("cpu")[1][1].b.shape == (5,)


@pytest.mark.parametrize("n, mesh", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)),
                                     (8, (4, 2))])
def test_dryrun_multichip_mesh_batch_and_launch(n, mesh, monkeypatch,
                                                capsys):
    seen = {}

    def fake_launch(argv, world, timeout):
        """Rank 0 alone: the unsharded gate on the plan's files."""
        seen.update(argv=argv, world=world, timeout=timeout)
        with open(argv[argv.index("--plan") + 1]) as f:
            case, = json.load(f)
        seen["case"] = case
        ck, x, y = (ser.load(case[k], "cpu") for k in ("key", "x", "y"))
        seen["batch"] = x.b.shape[0]
        out_dir = argv[argv.index("--out") + 1]
        ser.save(tp.gate_nand(ck, x, y),
                 os.path.join(out_dir, case["name"] + ".bin"))
        return [{"rank": 0, "results": [{"equal": True}]}]

    monkeypatch.setattr(dryrun, "launch", fake_launch)
    graft_entry.dryrun_multichip(n, "cpu")
    assert graft_entry.mesh_shape(n) == mesh
    assert seen["world"] == n and seen["timeout"] == dryrun.TIMEOUT_S
    argv = seen["argv"]
    assert argv[:4] == ["--device", "cpu", "--backend", "gloo"]
    case = seen["case"]
    assert case["kind"] == "nand" and tuple(case["mesh"]) == mesh
    assert seen["batch"] == 2 * n
    assert capsys.readouterr().out == \
        f"dryrun_multichip({n}): mesh=({mesh[0]},{mesh[1]}) OK\n"


def test_rank_backend_never_changes_silently(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert graft_entry.rank_backend(cpu, 8, None) == "gloo"
    with pytest.raises(ValueError):
        graft_entry.rank_backend(cpu, 1, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert graft_entry.rank_backend(card, 1, None) == "nccl"
    assert graft_entry.rank_backend(card, 8, "gloo") == "gloo"
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="gloo"):
            graft_entry.rank_backend(card, 8, backend)


def test_profile_bootstrap_lines_and_trace(tmp_path, capsys):
    assert profile_bootstrap.main([*CPU, "8", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"trace written to {tmp_path}"
    heads = ["measured: ", "byte-MACs: ", "HBM bytes: ", "ALU elems: "]
    assert [ln[:len(h)] for ln, h in zip(lines[1:], heads)] == heads
    assert "ms for 8 gates" in lines[1]
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_pbs_bench_line(capsys):
    assert pbs_bench.main([*CPU, "--params", "toy", "--batch", "16"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("toy: ") and line.endswith(
        " LUT4/s, correct 16/16")


def test_scaling_rank_body_in_one_rank_world(tmp_path, capsys):
    import torch.distributed as dist

    with open(os.path.join(REPO, "tools", "scaling_bench.py")) as f:
        ref = f.read()
    keys = ["metric", "per_device_batch", "rates", "efficiency_at_max"]
    assert all(f'"{k}"' in ref for k in keys)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        cpu = torch.device("cpu")
        sk, key = scaling_bench.make_key(cpu)
        objs = {"key": key, "secret": sk,
                **scaling_bench.make_inputs(cpu, sk, 4)}
        res = scaling_bench.run_size(dryrun.Rank(0, "cpu"), objs, 1)
    finally:
        dist.destroy_process_group()
    assert (res["rank"], res["devices"], res["batch"], res["correct"]) == \
        (0, 1, 4, 4)
    assert res["launches"] == {} and res["seconds"] > 0
    rates = {}
    scaling_bench.size_line(rates, [res])
    scaling_bench.json_line(4, rates)
    size, last = capsys.readouterr().out.strip().splitlines()
    assert size.startswith("devices= 1 batch=    4: ")
    assert size.endswith("(efficiency 100.0%)")
    line = json.loads(last)
    assert list(line) == keys
    assert line["metric"] == "scaling_efficiency"
    assert line["efficiency_at_max"] == 1.0 and list(line["rates"]) == ["1"]


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (graft_entry, profile_bootstrap, pbs_bench, scaling_bench):
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert "--device cpu" in str(e.value.code), mod.__name__
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(1)):
        with pytest.raises(SystemExit, match="--device cpu"):
            call()


def test_graft_entry_as_a_program_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "tfhe_tpu_torch.graft_entry"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr
    assert "OK" not in out.stdout


def test_every_reference_program_has_a_twin_or_a_reason():
    files = {os.path.relpath(p, REPO) for pattern in
             ("*.py", "tools/*", "examples/*.py")
             for p in glob.glob(os.path.join(REPO, pattern))
             if os.path.isfile(p)}
    listed = set(TWINS) | set(NOT_PORTED) | set(PORT_OWN)
    assert files == listed, (sorted(files - listed), sorted(listed - files))
    for script, module in TWINS.items():
        mod = importlib.import_module(f"tfhe_tpu_torch.{module}")
        assert callable(getattr(mod, "main", None)), script
    for script, reason in NOT_PORTED.items():
        assert reason, script
        stem = os.path.splitext(script)[0].replace("/", ".")
        assert importlib.util.find_spec(f"tfhe_tpu_torch.{stem}") is None
    assert callable(graft_entry.entry) and callable(
        graft_entry.dryrun_multichip)
