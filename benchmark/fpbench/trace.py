"""Reduction of a profiler trace (Chrome trace events) to what the
per-layer readers read.

A device operation is a ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event.
A kernel belongs to a span when the runtime call that launched it (same
``correlation``) started inside a ``user_annotation`` range of that name on
the same thread. Busy time is the union of the device operations' intervals
inside the traced window; the window is from the start of the first
``bench.call`` range to the end of the last.
"""

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench.call"


class EmptyTrace(RuntimeError):
    """The trace holds no device kernel: the run must fail, not read 0."""


def load_events(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals):
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce(events, top=10):
    """Returns {calls, window_s, busy_s, kernels, span_ms, device_ops,
    idle_gaps}. Raises EmptyTrace when no kernel ran."""
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == CALL)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise EmptyTrace("the profiler recorded no device kernel")
    if not calls:
        raise EmptyTrace(f"the trace holds no {CALL} range")
    w0, w1 = calls[0][0], calls[-1][1]
    device = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e) for e in events
              if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy_us = _union([(s, e) for s, e, _ in device])

    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch[corr] = e
    span_us = defaultdict(float)
    n_kernels = 0
    by_name = defaultdict(float)
    launched = []  # (launch time, launch thread, duration)
    for e in kernels:
        if not (w0 <= e["ts"] < w1):
            continue
        n_kernels += 1
        by_name[e["name"]] += e["dur"]
        rt = launch.get((e.get("args") or {}).get("correlation"))
        if rt is not None:
            launched.append((rt["ts"], rt.get("tid"), e["dur"]))
    ranges = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    sweeps = {tid: _Sweep(sorted(r)) for tid, r in ranges.items()}
    for ts, tid, dur in sorted(launched, key=lambda x: x[0]):
        if tid in sweeps:
            for name in sweeps[tid].open_at(ts):
                span_us[name] += dur

    main_tid = next(e.get("tid") for e in events
                    if e.get("cat") == "user_annotation" and e["name"] == CALL)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("tid") == main_tid and e["name"] != CALL
                  and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"))
    at = _Sweep(host)
    gaps = defaultdict(float)
    end = w0
    for s, e, _ in sorted(device, key=lambda x: x[0]):
        if s > end:
            gaps[at((end + s) / 2)] += s - end
        end = max(end, e)
    if w1 > end:
        gaps[at((end + w1) / 2)] += w1 - end
    return {
        "calls": len(calls), "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
        "kernels": n_kernels, "span_ms": {k: v / 1e3 for k, v in span_us.items()},
        "device_ops": [[k, v / 1e6] for k, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
    }


class _Sweep:
    """The ranges of one thread, sorted by start, open at ``t``, for ``t``
    that never decreases between calls. The ranges of one thread nest, so a
    stack swept forward holds the open ones, innermost last."""

    def __init__(self, ranges):
        self.ranges, self.i, self.stack = ranges, 0, []

    def open_at(self, t):
        while self.i < len(self.ranges) and self.ranges[self.i][0] <= t:
            r = self.ranges[self.i]
            while self.stack and self.stack[-1][1] < r[0]:
                self.stack.pop()
            self.stack.append(r)
            self.i += 1
        while self.stack and self.stack[-1][1] < t:
            self.stack.pop()
        return [r[2] for r in self.stack if r[1] >= t]

    def __call__(self, t):
        """The innermost open range's name, or ``python``."""
        names = self.open_at(t)
        return names[-1] if names else "python"
