"""The readers of the engine's own spans: device ms from the trace's
reduction, host ms from the engine's span records, None for an engine
without spans, and a failed run (never 0) where the spans are missing; and
no span of the engine has a name that the benchmark's own wraps use."""

import ast
import os

import pytest

from fpbench import cell as cell_mod, pose, program, trace

BENCH = cell_mod.BENCH_DIR
PORT = os.path.join(os.path.dirname(BENCH), "foundationpose_tpu_torch")


def _reader(metric):
    return cell_mod.Cell(BENCH, "geometric.register").reader(metric)


def _rec(name, parent, call, t0_ms, t1_ms):
    return {"name": name, "id": None, "parent": parent, "call": call, "n": None,
            "size": None, "start_ns": int(t0_ms * 1e6), "end_ns": int(t1_ms * 1e6)}


def canned_records():
    """Two tracked frames of 40 ms (call ids 7, 8) and a stray record of
    another call id, which no reader counts."""
    recs = []
    for call, t in ((7, 0.0), (8, 100.0)):
        top = len(recs)
        recs.append(_rec("estimator.track_one", None, call, t, t + 40))
        recs.append(_rec("estimator.precrop", top, call, t + 1, t + 4))
        recs.append(_rec("estimator.preprocess", top, call, t + 4, t + 6))
        refine = len(recs)
        recs.append(_rec("refiner.refine", top, call, t + 6, t + 26))
        recs.append(_rec("refiner.iteration", refine, call, t + 6, t + 16))
        recs.append(_rec("scorer.score", top, call, t + 26, t + 36))
        recs.append(_rec("estimator.readback.wait", top, call, t + 37, t + 39.5))
    recs.append(_rec("estimator.pose_last.wait", None, 9, 200.0, 300.0))
    for i, r in enumerate(recs):
        r["id"] = i
    return recs


@pytest.fixture
def engine_records(monkeypatch):
    from foundationpose_tpu_torch.utils import profiling

    recs = canned_records()
    monkeypatch.setattr(profiling, "records", lambda: recs)
    return recs


def test_host_readers(engine_records):
    assert _reader("precrop_host_ms.track")({}) == pytest.approx(3.0)
    assert _reader("launch_host_ms.track")({}) == pytest.approx(30.0)
    assert _reader("launch_host_ms.geometric")({}) == pytest.approx(30.0)
    assert _reader("wait_host_ms.track")({}) == pytest.approx(2.5)


def test_device_readers():
    rec = {"calls": 2, "span_ms": {
        trace.CALL: 300.0, "estimator.register": 280.0, "estimator.preprocess": 20.0,
        "crop.render": 10.0, "raster.K1r": 8.0, "crop.observe": 30.0, "refiner.net": 100.0,
        "refiner.net.forward": 99.0, "scorer.net": 40.0, "refiner.iteration": 150.0}}
    assert _reader("preprocess_ms.register")(rec) == pytest.approx(10.0)
    # K1r's span nests in crop.render and the outside wrap in refiner.net:
    # neither is subtracted twice
    assert _reader("glue_ms.register")(rec) == pytest.approx((280 - 200) / 2)
    geo = {"calls": 4, "span_ms": {"estimator.register": 400.0, "estimator.preprocess": 8.0,
                                   "crop.render": 40.0, "crop.observe": 100.0,
                                   "geometric.solve": 160.0}}
    assert _reader("glue_ms.geometric")(geo) == pytest.approx(23.0)


def test_missing_spans_fail_and_never_read_zero(monkeypatch):
    from foundationpose_tpu_torch.utils import profiling

    with pytest.raises(program.NoSpans):
        _reader("preprocess_ms.geometric")({"calls": 2, "span_ms": {trace.CALL: 1.0}})
    with pytest.raises(program.NoSpans):
        _reader("glue_ms.geometric")({"calls": 2, "span_ms": {trace.CALL: 1.0}})
    monkeypatch.setattr(profiling, "records", lambda: [])
    for metric in ("precrop_host_ms.track", "launch_host_ms.track", "wait_host_ms.register"):
        with pytest.raises(program.NoSpans):
            _reader(metric)({})
    # calls recorded, but none of the spans read
    top = [r for r in canned_records() if r["name"] == "estimator.track_one"]
    monkeypatch.setattr(profiling, "records", lambda: top)
    with pytest.raises(program.NoSpans):
        _reader("wait_host_ms.track")({})


def test_an_engine_without_spans_reads_none(monkeypatch):
    from foundationpose_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    for metric in ("preprocess_ms.register", "glue_ms.register", "precrop_host_ms.track",
                   "launch_host_ms.geometric", "wait_host_ms.track"):
        assert _reader(metric)({"calls": 1, "span_ms": {}}) is None


def program_span_names():
    """Every name the port passes to ``span`` as a string literal, and the
    kernel launch spans of ``ops/raster_cuda.py``."""
    names = set()
    for folder, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(folder, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    names.add(node.args[0].value)
    from foundationpose_tpu_torch.ops import raster_cuda

    return names | set(raster_cuda._SPANS.values())


def test_no_program_span_takes_a_name_of_the_benchmarks_wraps():
    class Wraps:
        def __init__(self):
            self.names = set()

        def wrap(self, owner, attr, name, keep=None):
            self.names.add(name)

    class Part:
        net = object()

    est = type("Est", (), {"refiner": Part(), "scorer": Part()})()
    wraps = Wraps()
    pose.install_spans(est, wraps)
    assert "imops.warp_crop_affine" in wraps.names  # the fake engine saw every wrap
    ours = program_span_names()
    assert {"estimator.register", "estimator.track_one", "raster.K1s", "crop.render"} <= ours
    assert not ours & (wraps.names | {trace.CALL})
