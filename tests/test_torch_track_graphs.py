"""The tracked frame's refine and score calls as CUDA graphs
(``engine/graphs.py``), held on the CPU.

A capture needs a card, so ``StandIn`` stands in for it: it records the
call's function with the static inputs it was captured on, and a replay runs
that function on them again and writes the result into its one static output
buffer, as a graph's replay overwrites its output. Through it the tests hold
the cache's contract: what a key is made of, when a graph is dropped, fresh
outputs, untouched inputs, only ``track_one`` handing a cache, the launch
counts of a replay, and the CPU's ``track_one`` unchanged. Also the
benchmark's reader of ``graph_share``.

Scene: the demo L-shape at 240x320 with 32 px crops and four tracking
hypotheses (the engine of test_torch_tracing.py), learned-hybrid, on the CPU.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from foundationpose_tpu_torch.apps import demo_synthetic as demo
from foundationpose_tpu_torch.engine import graphs
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig
from foundationpose_tpu_torch.ops import depth_cuda, kernels
from foundationpose_tpu_torch.utils import profiling

torch.set_num_threads(1)
PX = 32
CONFIG = EstimatorConfig(min_n_views=12, inplane_step=120, register_iterations=2,
                         final_refine_iterations=1, final_refine_top_k=4,
                         track_iterations=2, track_hypotheses=4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StandIn(graphs.GraphCache):
    """A graph cache whose capture records and replays on the CPU."""

    def __init__(self, launches=()):
        super().__init__()
        self.events = []  # "capture" / "replay", in order
        self.outputs = []  # every static output buffer
        self.launches = launches

    def _capture(self, fn, inputs):
        out = fn(*inputs)
        static = torch.empty_like(out)

        def replay():
            static.copy_(fn(*inputs))
            self.events.append("replay")

        self.events.append("capture")
        self.outputs.append(static)
        return out, graphs.Graph(replay, inputs, static, 7, self.launches)


@pytest.fixture(scope="module")
def world():
    scene = demo.make_scene((240, 320), device="cpu")
    frames = [(rgb, depth) for _, rgb, depth in demo.motion_frames(scene, 6)]
    return {"scene": scene, "frames": frames}


def _engine(world):
    s = world["scene"]
    est = demo.build_estimator(s["mesh"], device="cpu", config=CONFIG, input_size=PX)
    est.rot_grid = est.rot_grid[:8]
    est.register(s["K"], s["rgb"], s["depth"], s["mask"])
    return est


@pytest.fixture(scope="module")
def shared(world):
    """An engine the tests leave as they found it."""
    return _engine(world)


@pytest.fixture
def est(world):
    return _engine(world)


def _track(est, world, frames):
    return [est.track_one(rgb, depth, world["scene"]["K"]) for rgb, depth in frames]


def _call_inputs(est, world):
    """A tracked frame's refine arguments, as ``track_one`` builds them."""
    s, (rgb, depth) = world["scene"], world["frames"][0]
    K = torch.tensor(s["K"], dtype=torch.float32)
    _, xyz = depth_cuda.preprocess(torch.tensor(depth, dtype=torch.float32), K)
    c = torch.tensor(est.pose_last, dtype=torch.float32)
    poses = c.repeat(4, 1, 1)
    poses[1:, :3, 3] += torch.tensor([[0.004, 0, 0], [0, 0.004, 0], [0, 0, 0.004]])
    return {"mt": est.mesh_tensors, "rgb": torch.tensor(rgb, dtype=torch.float32),
            "xyz": xyz, "K": K, "poses": poses, "diam": float(est.diameter),
            "iteration": 2, "out_size": None, "gate_px": 12}


def _change(part, component, a, mp):
    """Change one component of a refine or score call's key: in the arguments
    ``a`` or, through ``mp``, in the refiner or scorer."""
    if component == "shape":
        a["rgb"], a["xyz"] = a["rgb"][:200], a["xyz"][:200]
    elif component == "hypotheses":
        a["poses"] = a["poses"][:3]
    elif component in ("iteration", "out_size", "gate_px"):
        a[component] = {"iteration": 1, "out_size": 24, "gate_px": 8}[component]
    elif component == "diameter":
        a["diam"] *= 1.01
    elif component == "config":
        mp.setattr(part, "cfg", dataclasses.replace(part.cfg, backface_cull=not
                                                    part.cfg.backface_cull))
    elif component == "geo_config":
        mp.setattr(part, "geo_cfg", dataclasses.replace(part.geo_cfg, w_edge=0.2))
    elif component == "weight":
        mp.setattr(part, "weight", 1.5)
    elif component == "mesh":
        a["mt"] = {k: v.clone() for k, v in a["mt"].items()}
    elif component == "parameter":
        conv = next(m for m in part.net.modules() if isinstance(m, torch.nn.Conv2d))
        mp.setattr(conv, "weight", torch.nn.Parameter(conv.weight.detach().clone()))
    else:
        raise ValueError(component)


def _invoke(est, part, a, cache):
    if part == "refine":
        return est.refiner.refine(a["mt"], a["rgb"], a["xyz"], a["K"], a["poses"], a["diam"],
                                  a["iteration"], out_size=a["out_size"],
                                  gate_px=a["gate_px"], graphs=cache)
    return est.scorer.score(a["mt"], a["rgb"], a["xyz"], a["K"], a["poses"], a["diam"],
                            out_size=a["out_size"], gate_px=a["gate_px"], graphs=cache)


KEY_CASES = [("refine", c) for c in ("shape", "hypotheses", "iteration", "out_size",
                                     "gate_px", "diameter", "config", "mesh", "parameter")] + \
            [("score", c) for c in ("shape", "hypotheses", "out_size", "gate_px", "diameter",
                                    "config", "geo_config", "weight", "mesh", "parameter")]


@pytest.mark.parametrize("part,component", KEY_CASES)
def test_each_key_component_starts_a_new_capture(shared, world, part, component):
    """A key's first call runs eagerly, its second captures, its third
    replays; with one component changed the call neither replays the old
    graph nor captures at once, and the changed key is captured on its own
    second call. The old key's graph is still replayed afterwards."""
    est = shared
    cache, a = StandIn(), _call_inputs(est, world)
    owner = est.refiner if part == "refine" else est.scorer
    base = [_invoke(est, part, a, cache) for _ in range(3)]
    assert cache.events == ["capture", "replay"]
    for out in base[1:]:
        assert torch.equal(out, base[0])
    with pytest.MonkeyPatch.context() as mp:
        b = dict(a)
        _change(owner, component, b, mp)
        _invoke(est, part, b, cache)
        assert cache.events == ["capture", "replay"]
        _invoke(est, part, b, cache)
        _invoke(est, part, b, cache)
        assert cache.events == ["capture", "replay", "capture", "replay"]
    assert torch.equal(_invoke(est, part, a, cache), base[0])
    assert cache.events[-1] == "replay" and len(cache._graphs) == 2


def test_weights_loaded_in_place_are_replayed(shared, world):
    """A weight written in place keeps the key: the next call replays and
    reads the new weight, as the eager call does."""
    est = shared
    cache, a = StandIn(), _call_inputs(est, world)
    for _ in range(2):
        _invoke(est, "refine", a, cache)
    conv = next(m for m in est.refiner.net.modules() if isinstance(m, torch.nn.Conv2d))
    kept = conv.weight.detach().clone()
    try:
        with torch.no_grad():
            conv.weight.mul_(1.5)
        replayed = _invoke(est, "refine", a, cache)
        assert cache.events == ["capture", "replay"]
        assert torch.equal(replayed, _invoke(est, "refine", a, None))
    finally:
        with torch.no_grad():
            conv.weight.copy_(kept)


def test_reset_object_and_a_replaced_parameter_drop_the_graph(est, world):
    cache = est._track_graphs = StandIn()
    frames = world["frames"]
    _track(est, world, frames[:3])
    assert cache.events == ["capture", "capture", "replay", "replay"]
    est.reset_object(est.mesh_ori)
    assert cache._graphs == {}
    _track(est, world, frames[3:4])
    assert cache.events[4:] == []  # eager: the first call of each key
    _track(est, world, frames[4:6])
    assert cache.events[4:] == ["capture", "capture", "replay", "replay"]

    conv = next(m for m in est.refiner.net.modules() if isinstance(m, torch.nn.Conv2d))
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 1.5)
    _track(est, world, frames[:1])
    assert cache.events[8:] == ["replay"]  # the score's graph; the refine ran eagerly
    _track(est, world, frames[1:2])
    assert cache.events[8:] == ["replay", "capture", "replay"]


def _recorded(est):
    """Wrap the estimator's refine and score as the benchmark's recorder
    does: keep what each call was given (and a copy of it) and returned."""
    calls = []

    def keeper(fn, kind):
        def kept(mesh_tensors, rgb, xyz_map, K, poses, *args, **kwargs):
            given = (rgb, xyz_map, K, poses)
            before = [t.clone() for t in given]
            out = fn(mesh_tensors, rgb, xyz_map, K, poses, *args, **kwargs)
            calls.append({"kind": kind, "given": given, "before": before, "out": out,
                          "out_copy": out.clone(), "graphs": kwargs.get("graphs")})
            return out
        return kept

    est.refiner.refine = keeper(est.refiner.refine, "refine")
    est.scorer.score = keeper(est.scorer.score, "score")
    return calls


def test_outputs_are_fresh_and_inputs_untouched(est, world):
    """Over frames that replay, each refine and score output is its own
    tensor, never a graph's static buffer, and no later frame changes it; the
    tensors each call was given are not written and not kept as buffers."""
    cache = est._track_graphs = StandIn()
    calls = _recorded(est)
    _track(est, world, world["frames"])
    assert cache.events.count("replay") == 2 * (len(world["frames"]) - 2)
    outs = [c["out"] for c in calls]
    assert len({id(o) for o in outs}) == len(outs)
    statics = [t for g in cache._graphs.values() for t in (g.output, *g.inputs)]
    for c in calls:
        assert torch.equal(c["out"], c["out_copy"])
        for t, before in zip(c["given"], c["before"]):
            assert torch.equal(t, before)
            assert all(t.data_ptr() != s.data_ptr() for s in statics)
        assert all(c["out"].data_ptr() != s.data_ptr() for s in statics)
    assert [c["kind"] for c in calls] == ["refine", "score"] * len(world["frames"])


def test_only_track_one_hands_a_cache(est, world):
    cache = est._track_graphs = StandIn()
    calls = _recorded(est)
    s = world["scene"]
    est.register(s["K"], s["rgb"], s["depth"], s["mask"])
    assert calls and all(c["graphs"] is None for c in calls)
    n = len(calls)
    _track(est, world, world["frames"][:1])
    assert [c["graphs"] for c in calls[n:]] == [cache, cache]


def test_replay_adds_the_captured_launches(est, world):
    """Each replay adds to the hand kernels' launch counters what the graph
    launches; the eager calls count their own launches (none on the CPU)."""
    cache = est._track_graphs = StandIn(launches=(("K1s", 2), ("K1r", 2), ("K2", 1)))
    before = dict(kernels.LAUNCHES)
    _track(est, world, world["frames"][:4])
    got = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    replays = cache.events.count("replay")
    assert replays == 4 and got == {"K1s": 2 * replays, "K1r": 2 * replays, "K2": replays}


def test_replay_span_counts_kernels(est, world, tmp_path):
    """Under the profiler a replayed call holds one ``graph.replay`` record,
    its ``n`` the graph's kernels."""
    est._track_graphs = StandIn()
    _track(est, world, world["frames"][:2])
    with profiling.trace(str(tmp_path), device="cpu"):
        _track(est, world, world["frames"][2:3])
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    replays = [r for r in recs if r["name"] == "graph.replay"]
    assert sorted(by_id[r["parent"]]["name"] for r in replays) == ["refiner.refine",
                                                                  "scorer.score"]
    assert all(r["n"] == 7 for r in replays)
    profiling.reset()


def test_cpu_track_one_is_unchanged(world):
    """On the CPU the estimator holds no cache and tracks eagerly; the same
    frames through a stand-in's captures and replays give the same bits."""
    plain = _engine(world)
    assert plain._track_graphs is None
    graphed = _engine(world)
    graphed._track_graphs = StandIn()
    a = _track(plain, world, world["frames"])
    b = _track(graphed, world, world["frames"])
    assert graphed._track_graphs.events.count("replay") == 2 * (len(world["frames"]) - 2)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert np.array_equal(plain.pose_last, graphed.pose_last)


def _graph_share(mp):
    mp.syspath_prepend(os.path.join(ROOT, "benchmark"))
    path = os.path.join(ROOT, "benchmark", "metrics", "graph_share.py")
    spec = importlib.util.spec_from_file_location("bench_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _records(replayed):
    """Span records of one tracked frame: refine, then score, each with a
    ``graph.replay`` child when ``replayed`` says so."""
    recs = [{"name": "estimator.track_one", "id": 0, "parent": None, "call": 0}]
    for name, rep in zip(("refiner.refine", "scorer.score"), replayed):
        parent = len(recs)
        recs.append({"name": name, "id": parent, "parent": 0, "call": 0})
        recs.append({"name": "graph.replay" if rep else "refiner.iteration",
                     "id": parent + 1, "parent": parent, "call": 0})
    return recs


@pytest.mark.parametrize("replayed,share", [((False, False), 0.0), ((True, False), 50.0),
                                            ((True, True), 100.0)])
def test_graph_share_reads_the_replayed_share(replayed, share):
    with pytest.MonkeyPatch.context() as mp:
        read = _graph_share(mp)
        mp.setattr(profiling, "_RECORDS", _records(replayed))
        assert read({}) == share
