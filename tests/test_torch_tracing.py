"""The port's own spans (``utils/profiling.span``) on its serving path.

With no profiler running a span records nothing and enters no profiler
range. Under ``torch.profiler`` every phase of a ``register`` and a
``track_one`` call lies in the trace as a ``user_annotation`` range inside
its call's range; the records nest in time, share one call id per call, and
their self times sum to the call's duration; the refine schedule and the
batch sizes show in the records; and poses and scores are the same bits with
and without the profiler.

Scene: the world of test_torch_engine.py (the demo L-shape at 240x320,
``min_n_views=12, inplane_step=120``) with the rotation grid cut to its
first 8 hypotheses (padded to 32), short schedules and 32 px crops (the
size of the benchmark's CPU copy: 64 px takes the plain rasterizer and the
nets several times as long), in the learned-hybrid and the geometric
engine, on the CPU.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from foundationpose_tpu_torch.apps import demo_synthetic as demo
from foundationpose_tpu_torch.engine.estimator import HYP_BUCKET, EstimatorConfig
from foundationpose_tpu_torch.ops import kernels
from foundationpose_tpu_torch.utils import profiling

torch.set_num_threads(1)
PX = 32
N_GRID = 8
CONFIG = EstimatorConfig(min_n_views=12, inplane_step=120, register_iterations=2,
                         final_refine_iterations=1, final_refine_top_k=4,
                         track_iterations=2, track_hypotheses=4)
CALLS = ("estimator.register", "estimator.track_one")
COMMON = {"refiner.refine", "refiner.iteration", "crop.render", "crop.observe", "scorer.score",
          "geometric.score", "estimator.preprocess", "estimator.readback.wait"}
MODE_SPANS = {"learned": {"refiner.net", "refiner.update", "scorer.net", "net.stem"},
              "geometric": {"geometric.iteration", "geometric.solve"}}
CALL_SPANS = {"estimator.register": {"estimator.register", "estimator.translation.wait",
                                     "estimator.polish"},
              "estimator.track_one": {"estimator.track_one", "estimator.precrop"}}


def expected_spans(mode, call):
    """The span names of one call on the CPU (K1's launch spans, ``raster.K1s``
    and ``raster.K1r``, exist only on a card)."""
    return COMMON | MODE_SPANS[mode] | CALL_SPANS[call]


@pytest.fixture(scope="module", params=["learned", "geometric"])
def runs(request, tmp_path_factory):
    """One ``register`` and one ``track_one``, first with no profiler (and
    ``record_function`` made to fail), then under ``profiling.trace``."""
    mode = request.param
    scene = demo.make_scene((240, 320), device="cpu")
    est = demo.build_estimator(scene["mesh"], device="cpu", config=CONFIG, input_size=PX,
                               mode=mode)
    est.rot_grid = est.rot_grid[:N_GRID]
    _, rgb1, depth1 = next(demo.motion_frames(scene, 1))
    K = scene["K"]

    def calls():
        pose = est.register(K, scene["rgb"], scene["depth"], scene["mask"])
        out = {"pose": pose, "poses": est.poses.copy(), "scores": est.scores.copy()}
        out["tracked"] = est.track_one(rgb1, depth1, K)
        return out

    entered = []

    def refuse(*args, **kwargs):
        entered.append(args)
        raise AssertionError("a span entered a profiler range with no profiler running")

    profiling.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        plain = calls()
    plain_records = list(profiling.records())
    log_dir = str(tmp_path_factory.mktemp(f"trace_{mode}"))
    with profiling.trace(log_dir, device="cpu"):
        traced = calls()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    with open(os.path.join(log_dir, "spans.json")) as f:
        written = json.load(f)
    recs = list(profiling.records())
    profiling.reset()
    return {"mode": mode, "plain": plain, "traced": traced, "entered": entered,
            "plain_records": plain_records, "events": events, "written": written,
            "recs": recs}


def _calls(recs):
    return [r for r in recs if r["parent"] is None]


def _of_call(recs, call):
    return [r for r in recs if r["call"] == call["call"]]


def test_unprofiled_calls_record_nothing_and_enter_no_range(runs):
    assert runs["plain_records"] == []
    assert runs["entered"] == []


def test_span_off_is_one_shared_no_op():
    assert profiling.span("estimator.register") is profiling.span("crop.render", 32, 64)
    with profiling.span("crop.render", 32, 64):
        pass
    assert profiling.records() == []


def test_profiler_changes_no_pose_or_score(runs):
    for key, value in runs["plain"].items():
        assert np.array_equal(value, runs["traced"][key]), key


def test_trace_holds_every_span_inside_its_call(runs):
    """Each span is a ``user_annotation`` range in the Chrome trace, inside
    the range of the call it belongs to, on the call's thread."""
    ranges = [e for e in runs["events"] if e.get("cat") == "user_annotation"]
    names = set().union(*(expected_spans(runs["mode"], c) for c in CALLS))
    for call in CALLS:
        (c,) = [e for e in ranges if e["name"] == call]
        inside = {e["name"] for e in ranges
                  if e["tid"] == c["tid"] and c["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= c["ts"] + c["dur"]}
        assert inside == expected_spans(runs["mode"], call)
    outside = [e["name"] for e in ranges if e["name"] in names and not any(
        c["ts"] <= e["ts"] and e["ts"] + e["dur"] <= c["ts"] + c["dur"]
        for c in ranges if c["name"] in CALLS)]
    assert outside == []


def test_records_nest_and_self_times_sum_to_the_call(runs):
    recs = runs["recs"]
    calls = _calls(recs)
    assert [c["name"] for c in calls] == list(CALLS)
    assert len({c["call"] for c in calls}) == 2
    for call in calls:
        mine = _of_call(recs, call)
        assert {r["name"] for r in mine} == expected_spans(runs["mode"], call["name"])
        children = {}
        for r in mine:
            assert r["start_ns"] <= r["end_ns"]
            if r is call:
                continue
            parent = recs[r["parent"]]
            assert parent["call"] == r["call"]
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
            children.setdefault(parent["id"], []).append(r)
        for kids in children.values():  # siblings follow one another
            for a, b in zip(kids, kids[1:]):
                assert a["end_ns"] <= b["start_ns"]
        self_ns = sum(r["end_ns"] - r["start_ns"]
                      - sum(k["end_ns"] - k["start_ns"] for k in children.get(r["id"], []))
                      for r in mine)
        assert self_ns == call["end_ns"] - call["start_ns"]


def test_records_show_the_schedule_and_the_batches(runs):
    """Per register: ``register_iterations`` + ``final_refine_iterations``
    refine iterations, the first refine and score over the padded grid and
    the polish's over its top k; per tracked frame: ``track_iterations``
    over ``track_hypotheses``; every crop at the configured size."""
    recs = runs["recs"]
    register, track = _calls(recs)
    n_pad = -(-N_GRID // HYP_BUCKET) * HYP_BUCKET
    k = CONFIG.final_refine_top_k

    def of(call, name):
        return [r for r in _of_call(recs, call) if r["name"] == name]

    its = CONFIG.register_iterations + CONFIG.final_refine_iterations
    assert len(of(register, "refiner.iteration")) == its
    assert [r["n"] for r in of(register, "refiner.refine")] == [n_pad, k]
    assert [r["n"] for r in of(register, "scorer.score")] == [n_pad, k]
    assert [r["n"] for r in of(register, "estimator.polish")] == [k]
    assert [r["n"] for r in of(track, "refiner.iteration")] == \
        [CONFIG.track_hypotheses] * CONFIG.track_iterations
    assert [r["n"] for r in of(track, "scorer.score")] == [CONFIG.track_hypotheses]
    assert {r["size"] for r in recs if r["name"] == "crop.render"} == {PX}
    if runs["mode"] == "geometric":  # each ICP iteration is one refine iteration
        for r in of(register, "geometric.iteration") + of(track, "geometric.iteration"):
            assert recs[r["parent"]]["name"] == "refiner.iteration"
    else:
        assert [r["n"] for r in of(register, "refiner.net")] == [n_pad] * 2 + [k]


def test_stem_span_reads_its_crops_and_channels(runs):
    """One ``net.stem`` per net forward, inside it: ``n`` the crops it took
    (rendered and observed, twice the forward's pairs) and ``size`` the
    channels it ran at, the crops' 6 on the CPU (padded only on a card)."""
    recs = runs["recs"]
    stems = [r for r in recs if r["name"] == "net.stem"]
    nets = [r for r in recs if r["name"] in ("refiner.net", "scorer.net")]
    assert len(stems) == len(nets)
    assert bool(nets) == (runs["mode"] == "learned")
    for r in stems:
        parent = recs[r["parent"]]
        assert parent["name"] in ("refiner.net", "scorer.net")
        assert (r["n"], r["size"]) == (2 * parent["n"], 6)


def test_trace_writes_spans_json(runs):
    written = runs["written"]
    assert written["records"] == runs["recs"]
    summary = profiling.summary(runs["recs"])
    assert written["summary"].keys() == summary.keys()
    for name, s in summary.items():
        assert written["summary"][name] == pytest.approx(s)


def test_summary_arithmetic():
    """Calls, total and self host ms (less the direct children), summed n."""
    def rec(i, name, parent, t0, t1, n=None):
        return {"name": name, "id": i, "parent": parent, "call": 0, "start_ns": t0,
                "end_ns": t1, "n": n, "size": None}

    recs = [rec(0, "call", None, 0, 10_000_000),
            rec(1, "refine", 0, 1_000_000, 6_000_000, 32),
            rec(2, "net", 1, 2_000_000, 3_000_000, 32),
            rec(3, "net", 1, 4_000_000, 5_500_000, 32),
            rec(4, "refine", 0, 7_000_000, 8_000_000, 4)]
    s = profiling.summary(recs)
    assert s["call"] == {"calls": 1, "total_ms": 10.0, "self_ms": 4.0, "n": None}
    assert s["refine"] == pytest.approx({"calls": 2, "total_ms": 6.0, "self_ms": 3.5, "n": 36})
    assert s["net"] == pytest.approx({"calls": 2, "total_ms": 2.5, "self_ms": 2.5, "n": 64})


def test_kernel_launch_has_its_span(monkeypatch):
    """``kernels.launch`` runs each launch call inside ``raster.K1s`` /
    ``raster.K1r`` / ``depth.K2``, passes the current stream last and counts
    it, with the launch functions and stream faked (the kernels themselves
    run only on a card)."""
    launched = []

    def fake(*args):
        launched.append(args)
        return 0

    monkeypatch.setattr(kernels, "build", lambda: dict.fromkeys(kernels.LIBRARIES, fake))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LIBRARIES, 0))
    monkeypatch.setattr(kernels, "_LAUNCHED_FNS", {k: {} for k in kernels.LIBRARIES})
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.launch("K1s", "cpu", 1, 2)
        kernels.launch("K1r", "cpu", 3)
        kernels.launch("K2", "cpu", 4)
    names = [r["name"] for r in profiling.records()]
    profiling.reset()
    assert names == ["raster.K1s", "raster.K1r", "depth.K2"]
    assert launched == [(1, 2, 0), (3, 0), (4, 0)]
    assert kernels.LAUNCHES == {"K1s": 1, "K1r": 1, "K2": 1}
