"""One run of one cell: set-up, the measured window, the traced part, the
metric readers and the judge. Nothing here knows a cell, a traffic mix, a
configuration or a metric by name; every file is found by the names that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration, as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters; its ``kind``
  names the module that drives it, ``kinds/<kind>.py``;
- ``limits/<cell>.json``: each number the judge compares, with its limit;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: a ``read`` for each
  end-to-end metric (over the window) and each per-layer metric (over the
  traced record), which returns a number or None. Where no file has the
  whole name, the one named by its part before the first dot reads it;
- ``controls/<control>.py``: the configuration's lower-precision control.
"""

import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import trace
from .peaks import H100
from .spans import Spans

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


_LOADED = {}


def load_module(bench_dir, folder, name):
    """``<folder>/<name>.py``, else ``<folder>/<part before the first
    dot>.py``; each file loaded once."""
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, folder, name.split(".")[0] + ".py")
    path = os.path.realpath(path)
    if path not in _LOADED:
        key = "bench_" + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and
    kind, limits and metric definitions, all found by name."""

    def __init__(self, bench_dir, name):
        self.bench_dir = bench_dir
        self.root = os.path.dirname(bench_dir)
        self.bench = load_json(self.root, "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.workload = name, cells[name]
        self.config = load_json(bench_dir, "configs", self.workload["config"] + ".json")
        self.traffic = load_json(bench_dir, "traffic", self.workload["traffic"] + ".json")
        self.limits = load_json(bench_dir, "limits", name + ".json")
        self.kind = load_module(bench_dir, "kinds", self.traffic["kind"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in self.bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in self.bench["per_layer"] if mine(m)]

    def reader(self, metric):
        return load_module(self.bench_dir, "metrics", metric).read

    def e2e_reader(self, metric):
        return load_module(self.bench_dir, "e2e", metric).read

    def control(self, inputs, device):
        """The configuration's control: (a reference in a lower precision,
        a context that sets that precision round its calls)."""
        def make(**kw):
            return self.kind.reference(self, inputs, device, **kw)

        return load_module(self.bench_dir, "controls", self.config["control"]).build(make)


def run(cell, seed, seconds, traced, device, t_start, out=sys.stderr, keep=None):
    """One run. Returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, ``checks``).
    ``keep``, a dict, receives the run's inputs and what the judge read,
    for a control to be judged on the same calls."""
    cfg, tr, kind = cell.config, cell.traffic, cell.kind
    inputs = kind.make_inputs(seed, cfg, tr, device)
    client = kind.Client(cfg, tr, inputs, device)
    spans = Spans()
    if traced:
        client.install_spans(spans)
        spans.wrap(client, "call", trace.CALL)
    client.start()
    for _ in range(tr["warm_calls"]):
        client.call()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    client.clear()
    latencies, units = [], 0

    def one():
        nonlocal units
        t = time.perf_counter()
        units += client.call()
        latencies.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    rec = None
    if traced:
        rec = _traced_calls(one, spans, tr["trace_calls"], cuda)
        rec["config"] = cfg
        print("trace " + json.dumps({k: v for k, v in rec.items()
                                     if k not in ("kept", "peaks", "config")}), file=out)
    t1, n1 = time.perf_counter(), len(latencies)
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        one()
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans.restore()
    client.close()

    result = {"correct": None, "attempted": len(latencies), "failed": 0}
    if traced:
        rest = len(latencies) - n1
        rec["wall_s_per_call"] = (t_end - t1) / rest if rest else None
        metrics = {m["name"]: (cell.reader(m["name"])(rec), m["unit"]) for m in cell.per_layer}
    else:
        window = {"setup_s": setup_s, "window_s": t_end - t0, "units": units,
                  "latencies": latencies}
        metrics = {m["name"]: (cell.e2e_reader(m["name"])(window), m["unit"])
                   for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()
                         if v is not None}
    result["device"] = _device(device, peak)
    if traced:
        result["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}

    state = client.state()
    del client, spans, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = check(cell, seed, state, device, out)
    if keep is not None:
        keep.update(state=state, readings=readings)
    result["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


def _traced_calls(one, spans, n_calls, cuda):
    """``n_calls`` calls under the profiler, with the layer spans on; the
    trace's reduction plus what the span hooks kept."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.active = True
    with profile(activities=acts) as prof:
        for _ in range(n_calls):
            one()
        if cuda:
            torch.cuda.synchronize()
    spans.active = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        rec = trace.reduce(trace.load_events(path))
    finally:
        os.remove(path)
    rec.update(kept=spans.calls, peaks=H100)
    return rec


def _device(device, peak):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
            "memory_peak_bytes": int(peak)}


def check(cell, seed, state, device, out, control=False):
    """The judge over a seeded sample of the window's calls; with
    ``control`` the configuration's control stands in for the engine's
    outputs. Returns ({number: {value, limit}}, the readings of each judged
    call) and prints each number beside its limit."""
    kind = cell.kind
    rng = np.random.default_rng([seed % 2**64, 4])  # the kind draws its sample from it
    with _reference_precision():
        ref = kind.reference(cell, state["inputs"], device)
        ctl = cell.control(state["inputs"], device) if control else None
        try:
            readings = kind.judge(cell, state, rng, ref, ctl)
            numbers = kind.summarize(readings, list(cell.limits))
        except StructureError as e:
            print(f"check: {e}", file=out)
            readings, numbers = [], {k: float("inf") for k in cell.limits}
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=out)
    return checks, readings


class StructureError(RuntimeError):
    """The system's calls no longer have the form the judge follows."""


@contextlib.contextmanager
def _reference_precision():
    """float32 with TF32 off, and no autograd, around the reference."""
    from reference import tf32

    with torch.no_grad(), tf32(False):
        yield
