"""The readers of the program's own spans (`tfhe.*`, opened inside
tfhe_tpu_torch) on a synthetic Chrome trace of two traced requests, in the
style of `test_bench_trace.py`: a blocking copy inside the keyswitch, and
the harness's copy to the host after the gate."""

from __future__ import annotations

import types

import pytest

from benchmark.run import load_reader
from benchmark.trace import TraceView
from benchmark.tests.test_bench_trace import _events as _harness_events

READERS = ["before_rotation_ms.b1", "after_rotation_ms.b1",
           "keyswitch_ms.b1", "host_syncs_per_request.b1",
           "enqueue_us_per_step.b1"]


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    evs = []
    for u, t0 in enumerate((0.0, 2000.0)):
        c = 10 * u
        span = "user_annotation"
        evs += [
            _x(span, "bench.unit", t0, 1000),
            _x(span, "tfhe.gate", t0 + 10, 790),
            _x(span, "tfhe.modswitch", t0 + 50, 50),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 60, 5, corr=c + 1),
            _x(span, "tfhe.rotation", t0 + 110, 290),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 120, 5, corr=c + 2),
            _x(span, "tfhe.enqueue", t0 + 150, 40),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 160, 5, corr=c + 3),
            _x(span, "tfhe.enqueue", t0 + 200, 20),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 210, 5, corr=c + 4),
            _x(span, "tfhe.extract", t0 + 410, 40),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 420, 5, corr=c + 5),
            _x(span, "tfhe.keyswitch", t0 + 460, 240),
            _x("cuda_runtime", "cudaMemcpyAsync", t0 + 470, 4, corr=c + 6),
            _x("cuda_runtime", "cudaStreamSynchronize", t0 + 475, 60),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 600, 5, corr=c + 7),
            # the harness's copy to the host, after the gate
            _x("cuda_runtime", "cudaMemcpyAsync", t0 + 810, 2, corr=c + 8),
            _x("cuda_runtime", "cudaStreamSynchronize", t0 + 812, 10),
            _x("kernel", "decode", t0 + 70, 10, 7, c + 1),
            _x("kernel", "copy", t0 + 130, 10, 7, c + 2),
            _x("kernel", "rotate_decompose_kernel<8>", t0 + 170, 30, 7,
               c + 3),
            _x("kernel", "leaf_dots_kernel", t0 + 220, 300, 7, c + 4),
            _x("kernel", "extract", t0 + 525, 5, 7, c + 5),
            _x("gpu_memcpy", "Memcpy HtoD", t0 + 531, 2, 7, c + 6),
            _x("kernel", "sm90_gemm_s8", t0 + 605, 100, 7, c + 7),
            _x("gpu_memcpy", "Memcpy DtoH", t0 + 815, 5, 7, c + 8),
        ]
    return evs


def _run(events, loop="closed"):
    cfg = {"scheme": "cggi", "lwe_size": 2}
    return types.SimpleNamespace(trace=TraceView(events), loop=loop,
                                 config=cfg, batch=1, units=2,
                                 rotations_per_row=1)


def read(name, run):
    return load_reader(name).read(run)


def test_readers_against_hand_worked_numbers():
    run = _run(_events())
    # gate start 10 -> first rotation operation (the prologue's copy) 130
    assert read("before_rotation_ms.b1", run) == pytest.approx(0.120)
    # last rotation end 520 -> the keyswitch GEMM's end 705
    assert read("after_rotation_ms.b1", run) == pytest.approx(0.185)
    # the copy to the card (2 us) and the GEMM (100 us)
    assert read("keyswitch_ms.b1", run) == pytest.approx(0.102)
    # the keyswitch's synchronise; not the harness's, outside the gate
    assert read("host_syncs_per_request.b1", run) == 1.0
    # 40 + 20 us of enqueue over the 2 steps of a rotation
    assert read("enqueue_us_per_step.b1", run) == pytest.approx(30.0)


def test_the_split_fits_inside_the_time_outside_the_rotation():
    run = _run(_events())
    outside = read("outside_rotation_ms.b1", run)
    assert outside == pytest.approx(0.610)  # 1000 us less 520 - 130
    assert read("before_rotation_ms.b1", run) \
        + read("after_rotation_ms.b1", run) <= outside


@pytest.mark.parametrize("name", READERS)
def test_none_on_the_chained_loop(name):
    assert read(name, _run(_events(), loop="chained")) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_program_spans(name):
    """A trace of the harness's `bench.unit` spans alone."""
    events = [e for e in _harness_events()
              if not e["name"].startswith("tfhe.")]
    assert read(name, _run(events)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_a_request_lacks_its_spans(name):
    events = [e for e in _events()
              if not (e["ts"] >= 2000 and e["name"].startswith("tfhe."))]
    assert read(name, _run(events)) is None
