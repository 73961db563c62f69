"""Metric arithmetic: rates over all the work of the window, the p95 over
every frame, the trace reduction on a canned profiler trace (and its refusal
of a trace without kernels), and the per-layer readers on its result."""

import json

import numpy as np
import pytest

from fpbench import cell as cell_mod, trace
from fpbench.peaks import H100

BENCH = cell_mod.BENCH_DIR


def _e2e(name, latencies, window_s, setup_s=1.0, units=None):
    c = cell_mod.Cell(BENCH, "learned.track")
    window = {"setup_s": setup_s, "window_s": window_s, "latencies": latencies,
              "units": len(latencies) if units is None else units}
    return c.e2e_reader(name)(window)


def test_rates_are_all_work_over_the_window():
    lat = [0.25] * 79 + [0.75]  # one slow call among 80
    assert _e2e("register_ms", lat, 20.5) == pytest.approx(20.5e3 / 80)
    assert _e2e("register_ms.geometric", lat, 20.5) == pytest.approx(20.5e3 / 80)
    assert _e2e("track_fps", lat, 20.5) == pytest.approx(80 / 20.5)
    assert _e2e("setup_s", lat, 20.5, 12.0) == 12.0
    # a call that completes many units (a chunk of steps) counts them all
    assert _e2e("track_fps", lat, 20.5, units=800) == pytest.approx(800 / 20.5)


def test_p95_is_over_every_frame():
    lat = list(np.linspace(0.01, 0.2, 200))
    assert _e2e("track_ms_p95", lat, 10.0) == pytest.approx(1e3 * np.percentile(lat, 95))
    # a tail of ten slow frames in two hundred moves it
    assert _e2e("track_ms_p95", lat[:190] + [1.0] * 10, 10.0) >= 1e3 * 0.19


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned():
    """Two calls of 1000 us; the first launches a net kernel (100 us) and a
    raster kernel (50 us), the second a memcpy (20 us) and one kernel outside
    any span (30 us)."""
    ev = [
        _x(trace.CALL, "user_annotation", 0, 1000),
        _x("refiner.net.forward", "user_annotation", 10, 200),
        _x("aten::conv2d", "cpu_op", 20, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 5, corr=1),
        _x("raster_cuda.rasterize_cuda", "user_annotation", 300, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=2),
        _x(trace.CALL, "user_annotation", 1000, 1000),
        _x("cudaMemcpyAsync", "cuda_runtime", 1100, 5, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 1200, 5, corr=4),
        _x("conv_kernel", "kernel", 40, 100, tid=7, corr=1),
        _x("raster_kernel", "kernel", 320, 50, tid=7, corr=2),
        _x("Memcpy HtoD", "gpu_memcpy", 1110, 20, tid=7, corr=3),
        _x("add_kernel", "kernel", 1210, 30, tid=7, corr=4),
    ]
    return ev


def test_trace_reduction(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": canned()}))
    r = trace.reduce(trace.load_events(str(path)))
    assert r["calls"] == 2 and r["kernels"] == 3
    assert r["window_s"] == pytest.approx(2000e-6)
    assert r["busy_s"] == pytest.approx(200e-6)
    assert r["span_ms"]["refiner.net.forward"] == pytest.approx(0.1)
    assert r["span_ms"]["raster_cuda.rasterize_cuda"] == pytest.approx(0.05)
    assert r["span_ms"][trace.CALL] == pytest.approx(0.18)
    assert dict(r["device_ops"])["conv_kernel"] == pytest.approx(100e-6)
    gaps = dict(r["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1800e-6)
    # the gap before the first kernel falls inside conv2d, the innermost
    # host operation running at its middle; the rest inside no operation
    assert gaps == pytest.approx({"aten::conv2d": 40e-6, "python": 1760e-6})


def test_trace_without_kernels_fails():
    ev = [e for e in canned() if e["cat"] != "kernel"]
    with pytest.raises(trace.EmptyTrace):
        trace.reduce(ev)
    with pytest.raises(trace.EmptyTrace):
        trace.reduce([])


def _rec(**over):
    r = trace.reduce(canned())
    r.update(kept={}, config={}, peaks=H100, wall_s_per_call=0.25)
    r.update(over)
    return r


def test_readers():
    c = cell_mod.Cell(BENCH, "learned.register")
    rec = _rec()
    assert c.reader("launches_per_call.register")(rec) == pytest.approx(1.5)
    assert c.reader("idle_share.register")(rec) == pytest.approx(90.0)
    assert c.reader("nets_ms.register")(rec) == pytest.approx(0.05)
    assert c.reader("warp_ms.register")(rec) is None
    assert c.reader("icp_ms.geometric")(rec) is None
    assert c.reader("k1_roofline.register")(rec) is None
    # one reader serves every cell's copy of a quantity
    assert c.reader("idle_share.track") is c.reader("idle_share.geometric")


def test_mfu_reader():
    c = cell_mod.Cell(BENCH, "learned.register")
    net = c.config["net"]
    from counts import nets

    kept = {"refiner.net.forward": [(256, 160, 160, 6)], "scorer.net.forward": [(256, 160, 160, 6)]}
    rec = _rec(kept=kept, config={"net": net}, calls=2, wall_s_per_call=0.5)
    flops = nets.refinenet(256, 160, 160, net) + nets.scorenet(256, 160, 160, net)
    assert c.reader("register_mfu")(rec) == pytest.approx(100 * flops / 2 / (0.5 * 989e12))
