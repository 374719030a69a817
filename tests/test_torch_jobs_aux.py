"""Checkpointed jobs, telemetry, profiling and debug mode against
`tfhe_tpu`.

* `job_fingerprint` hashes the same bytes as the reference's for the same
  circuit and schedule (and the same result-affecting knobs), so a
  checkpoint carries over between the packages;
* a job preempted after its first chunk resumes to the uninterrupted
  run's words, and a checkpoint of another job is ignored;
* `noise_margin` gives the reference's report; `bootstrap_roofline` counts
  the reference's int8 multiply-adds; `trace` writes a Chrome trace;
* debug mode on the CPU: the crosscheck is clean for every key form and
  returns the reference's words, and raises `FHEDebugError` when the
  dispatcher's output is corrupted (as `tests/test_pallas_cmux.py` does it
  for the reference).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import netlist as j_net
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.utils import jobs as j_jobs
from tfhe_tpu.utils import profiling as j_prof
from tfhe_tpu.utils import serialization as js
from tfhe_tpu.utils import telemetry as j_tel
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import debug as p_debug
from tfhe_tpu_torch import netlist as p_net
from tfhe_tpu_torch import tuning as p_tuning
from tfhe_tpu_torch.utils import jobs as p_jobs
from tfhe_tpu_torch.utils import profiling as p_prof
from tfhe_tpu_torch.utils import serialization as ps
from tfhe_tpu_torch.utils import telemetry as p_tel

torch.set_num_threads(2)


def adder(net, bits, outputs):
    circ = net.Circuit()
    a, b = circ.inputs(bits), circ.inputs(bits)
    out = net.build_kogge_stone_adder(circ, a, b)
    sched = circ.compile(use_native=False, outputs=out if outputs else None)
    return circ, sched, a, b, out


@pytest.mark.parametrize("outputs", [False, True])
def test_job_fingerprint_matches_reference(outputs):
    _, s_j, *_ = adder(j_net, 4, outputs)
    _, s_p, *_ = adder(p_net, 4, outputs)
    for name in ("gate_order", "batch_start", "batch_type"):
        np.testing.assert_array_equal(getattr(s_p, name), getattr(s_j, name))
    assert repr(tp.tfhe_parameters_toy()) == repr(tt.tfhe_parameters_toy())
    for knobs in ({}, dict(debug=True), dict(radix_manylut=False)):
        with j_tuning.override(**knobs) as j, p_tuning.override(**knobs) as p:
            assert p.result_fingerprint() == j.result_fingerprint()
            fp = p_jobs.job_fingerprint(s_p, tp.tfhe_parameters_toy(), (3,))
            assert fp == j_jobs.job_fingerprint(
                s_j, tt.tfhe_parameters_toy(), (3,))
    assert fp != p_jobs.job_fingerprint(s_p, tp.tfhe_parameters_toy(), (2,))


@pytest.fixture(scope="module")
def toy_keys():
    g = torch.Generator().manual_seed(21)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    return g, sk, ck


class Preempted(Exception):
    pass


def test_resume_after_preemption_is_exact(toy_keys, tmp_path):
    g, sk, ck = toy_keys
    circ, sched, a, b, out = adder(p_net, 3, True)
    batch = (2,)
    x = torch.tensor([5, 6])
    y = torch.tensor([3, 7])
    inputs = {}
    for wires, v in ((a, x), (b, y)):
        for i, w in enumerate(wires):
            inputs[w] = tp.encrypt(g, sk, ((v >> i) & 1).bool())
    want = sched.run(ck, inputs, batch)
    path = str(tmp_path / "job.ckpt")
    assert sched.n_batches > 2

    def stop(done, total):
        raise Preempted(done)

    with pytest.raises(Preempted):
        p_jobs.run_checkpointed(sched, ck, inputs, path, batch_shape=batch,
                                every=2, on_chunk=stop)
    assert os.path.exists(path)
    fp = p_jobs.job_fingerprint(sched, ck.params, batch)
    # the file is the reference's format: the reference reads it too
    ref_next, ref_state = j_jobs.load_checkpoint(path, fp)
    assert ref_next == 2
    np.testing.assert_array_equal(np.asarray(ref_state.b),
                                  p_jobs.load_checkpoint(path, fp, "cpu")[1]
                                  .b.numpy())
    seen = []
    got = p_jobs.run_checkpointed(sched, ck, inputs, path, batch_shape=batch,
                                  every=2, on_chunk=lambda d, t: seen.append(d))
    assert seen[0] == 4 and not os.path.exists(path)
    for name in ("a", "b"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    total = sum(tp.decrypt(sk, sched.wire(got, w)).long() << i
                for i, w in enumerate(out))
    assert torch.equal(total, (x + y) % 8)
    # a checkpoint of another job (another fingerprint) is ignored
    js.save((fp[::-1], 2, js.loads(ps.dumps(want))), path)
    seen.clear()
    again = p_jobs.run_checkpointed(sched, ck, inputs, path,
                                    batch_shape=batch, every=2,
                                    on_chunk=lambda d, t: seen.append(d))
    assert seen[0] == 2 and torch.equal(again.a, want.a)
    assert p_jobs.load_checkpoint(str(tmp_path / "none"), fp) is None


def test_noise_margin_matches_reference():
    sk = tt.make_secret_key(jax.random.PRNGKey(2), tt.tfhe_parameters_toy())
    bits = jnp.asarray([True, False, True, True, False, False])
    ct = tt.encrypt(jax.random.PRNGKey(3), sk, bits)
    sk_p, ct_p = (ps.loads(js.dumps(o), device="cpu") for o in (sk, ct))
    for expected in (None, bits, ~bits):
        want = j_tel.noise_margin(sk, ct, expected)
        got = p_tel.noise_margin(
            sk_p, ct_p, None if expected is None
            else torch.from_numpy(np.array(expected)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.healthy() == want.healthy()
    with p_tel.GateThroughput(6) as meter:
        meter.block_on((ct_p, [ct_p.b]))
    assert meter.gates_per_second > 0


@pytest.mark.parametrize("preset,depth", [("tfhe_parameters_128_fast", 1),
                                          ("tfhe_parameters_128_pbs", 2),
                                          ("tfhe_parameters_128_radix", 2)])
def test_bootstrap_roofline_counts(preset, depth):
    want = j_prof.bootstrap_roofline(getattr(tt, preset)(), 4096, depth)
    got = p_prof.bootstrap_roofline(getattr(tp, preset)(), 4096, depth)
    assert got.byte_macs == want.byte_macs
    assert got.alu_elems == want.vpu_elems
    assert got.int8_floor_s == 2.0 * got.byte_macs / 1979e12
    util = got.utilization(2 * got.int8_floor_s)
    assert util["int8"] == 0.5 and util["floor_s"] >= got.hbm_floor_s
    if preset == "tfhe_parameters_128_fast":
        # the per-step operations floor of chip_smoke.py's row-1 bound
        per_step = got.int8_floor_s / tp.tfhe_parameters_128_fast().lwe_size
        assert abs(per_step - 54.3e-6) < 0.01 * 54.3e-6


def test_trace_writes_a_chrome_trace(tmp_path):
    with p_prof.trace(str(tmp_path)) as where:
        torch.ones(64).cumsum(0)
    with open(os.path.join(where, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def words(rng, shape):
    return torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape,
                                         dtype=np.int64).astype(np.int32))


@pytest.fixture(scope="module")
def rotation_case():
    """A small random key (n = 64, l = 3, b = 7, K = 2, 4 steps) and
    accumulators, and the reference's rotation through its XLA path."""
    rng = np.random.default_rng(123)
    n, l, b, k1, n_lwe, batch = 64, 3, 7, 2, 4, 4
    gsw = words(rng, (n_lwe, l, k1, k1, n))
    acc = tp.TLweSample(words(rng, (batch, k1, n)), torch.zeros(batch))
    bara = torch.from_numpy(rng.integers(0, 2 * n, size=(batch, n_lwe))
                            .astype(np.int32))
    bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw.numpy()), l, b,
                                       depth=2)
    with j_tuning.override(cmux="xla"):
        want = j_bs.blind_rotate(
            tt.TLweSample(jnp.asarray(acc.a.numpy()), jnp.zeros(batch)),
            bk_j, jnp.asarray(bara.numpy())).a
    return gsw, acc, bara, np.asarray(want), (l, b)


FORMS = {"baked": dict(), "compact": dict(bs_bake_budget=0),
         "dense": dict(karatsuba_depth=0)}


@pytest.mark.parametrize("form", FORMS)
def test_debug_crosscheck_is_clean(rotation_case, form):
    gsw, acc, bara, want, (l, b) = rotation_case
    with p_tuning.override(**FORMS[form]):
        bk = p_bs.bootstrap_key_from_raw(gsw, l, b, depth=None)
    assert bk.layout == ("compact" if form == "compact" else "reference")
    with p_tuning.override(debug=True):
        got = p_bs.blind_rotate(acc, bk, bara)
    np.testing.assert_array_equal(got.a.numpy(), want)
    assert torch.equal(got.cv, p_bs.blind_rotate(acc, bk, bara).cv)


@pytest.mark.parametrize("form,dispatcher", [("baked", "blind_rotate_baked"),
                                             ("compact",
                                              "blind_rotate_compact")])
def test_debug_crosscheck_raises_on_a_corrupted_engine(rotation_case, form,
                                                       dispatcher,
                                                       monkeypatch):
    gsw, acc, bara, want, (l, b) = rotation_case
    with p_tuning.override(**FORMS[form]):
        bk = p_bs.bootstrap_key_from_raw(gsw, l, b)
    real = getattr(p_bs, dispatcher)

    def corrupted(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0, 0] += 1
        return out

    monkeypatch.setattr(p_bs, dispatcher, corrupted)
    with p_tuning.override(debug=True):
        with pytest.raises(p_debug.FHEDebugError, match="crosscheck failed"):
            p_bs.blind_rotate(acc, bk, bara)
    with p_tuning.override(debug=False):
        assert not np.array_equal(p_bs.blind_rotate(acc, bk, bara).a.numpy(),
                                  want)


def test_check_gadget_invariants(monkeypatch):
    rng = np.random.default_rng(4)
    x = words(rng, (3, 2, 64))
    for balanced in (False, True):
        p_debug.check_gadget_invariants(x, 3, 7, balanced)
    real = p_debug.decompose
    monkeypatch.setattr(p_debug, "decompose",
                        lambda *a: real(*a) * 2)  # digits out of range
    with pytest.raises(p_debug.FHEDebugError, match="gadget invariant"):
        p_debug.check_gadget_invariants(x, 3, 7, False)
