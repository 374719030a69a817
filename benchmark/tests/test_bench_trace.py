"""The trace reading and the per-layer readers on a synthetic Chrome trace
of two traced units (the event kinds torch.profiler writes)."""

from __future__ import annotations

import types

import pytest

from benchmark.run import load_reader
from benchmark.trace import TraceView


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    evs = []
    for u, t0 in enumerate((0.0, 1000.0)):
        c = 10 * u
        evs += [
            _x("user_annotation", "bench.unit", t0, 400),
            _x("user_annotation", "tfhe.rotation", t0 + 10, 100),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5, corr=c + 1),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 40, 5, corr=c + 2),
            _x("user_annotation", "tfhe.keyswitch", t0 + 150, 100),
            _x("cpu_op", "aten::_int_mm", t0 + 160, 30),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 170, 5, corr=c + 3),
            _x("cuda_runtime", "cudaMemcpyAsync", t0 + 300, 90, corr=c + 4),
            _x("kernel", "rotate_decompose_kernel<8>", t0 + 30, 20, 7, c + 1),
            _x("kernel", "leaf_dots_kernel", t0 + 60, 140, 7, c + 2),
            _x("kernel", "sm90_gemm_s8", t0 + 210, 50, 7, c + 3),
            _x("gpu_memcpy", "Memcpy DtoH", t0 + 320, 60, 7, c + 4),
        ]
    # a kernel launched outside the units, after the window
    evs += [_x("cuda_runtime", "cudaLaunchKernel", 1500, 5, corr=99),
            _x("kernel", "other", 1600, 10, 7, 99)]
    return evs


@pytest.fixture()
def view():
    return TraceView(_events())


def test_window_busy_and_attribution(view):
    assert view.window() == (0.0, 1400.0)
    assert view.busy_s() == pytest.approx(2 * 270e-6)
    assert view.window_s() == pytest.approx(1400e-6)
    rot = view.launched_in("tfhe.rotation")
    assert [op[2] for op in rot] == ["rotate_decompose_kernel<8>",
                                     "leaf_dots_kernel"] * 2
    assert sorted(view.by_unit(rot)) == [0, 1]
    assert view.seconds(view.launched_in("tfhe.keyswitch")) == \
        pytest.approx(100e-6)
    assert view.top_ops(1) == [["leaf_dots_kernel", pytest.approx(280e-6)]]
    gaps = dict(view.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(1400e-6 - 540e-6)
    assert gaps == pytest.approx({
        "tfhe.rotation": 50e-6, "tfhe.keyswitch": 20e-6,
        "bench.unit": 120e-6, "cudaMemcpyAsync": 20e-6,
        "(no host operation)": 650e-6})


def _run(view, loop):
    cfg = {"scheme": "cggi", "lwe_size": 2, "tlwe_polynomial_degree": 1024,
           "tlwe_mask_size": 1, "bs_decomp_length": 3, "bs_log2_base": 7}
    return types.SimpleNamespace(trace=view, loop=loop, config=cfg, batch=1,
                                 units=2, key_bytes=2**30,
                                 rotations_per_row=1)


def test_readers(view):
    b4 = _run(view, "chained")
    b1 = _run(view, "closed")

    def read(name, run):
        return load_reader(name).read(run)

    assert read("rotation_ms_per_layer.b4096", b4) == pytest.approx(0.16)
    assert read("keyswitch_ms_per_layer.b4096", b4) == pytest.approx(0.05)
    assert read("rotation_ms_per_layer.b4096", b1) is None
    assert read("device_idle_pct.b4096", b4) == \
        pytest.approx(100 * (1 - 540 / 1400))
    assert read("launches_per_layer.b1", b1) == 4
    assert read("outside_rotation_ms.b1", b1) == pytest.approx(0.23)
    assert read("dots_us_per_step.b1", b1) == pytest.approx(280 / 4)
    assert read("key_gib", b4) == 1.0
    share = read("dots_roofline_pct.b4096", b4)
    assert 0 < share < 100


def test_nested_spans_of_one_name_are_read_whole():
    """A launch inside an outer span after an inner one of the same name
    has ended belongs to the span: the spans of a name are one union."""
    evs = [
        _x("user_annotation", "bench.unit", 0, 500),
        _x("user_annotation", "tfhe.keyswitch", 10, 300),
        _x("user_annotation", "tfhe.keyswitch", 20, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
        _x("user_annotation", "tfhe.keyswitch", 100, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=3),
        _x("user_annotation", "tfhe.keyswitch", 290, 60),
        _x("cuda_runtime", "cudaLaunchKernel", 340, 5, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, corr=5),
    ] + [_x("kernel", f"k{c}", 450 + 10 * c, 5, 7, c) for c in range(1, 6)]
    view = TraceView(evs)
    assert view.spans["tfhe.keyswitch"].spans == [(10, 350)]
    assert [op[2] for op in view.launched_in("tfhe.keyswitch")] == \
        ["k1", "k2", "k3", "k4"]
    run = _run(view, "chained")
    run.units = 1
    assert load_reader("keyswitch_ms_per_layer.b4096").read(run) == \
        pytest.approx(0.02)
