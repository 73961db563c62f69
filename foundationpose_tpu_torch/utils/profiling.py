"""Per-stage timing, the program's own spans, and profiler traces.

Counterpart of foundationpose_tpu/utils/profiling.py: ``StageTimer``, an
accumulating wall-clock timer with a running report, and ``trace``, a
``torch.profiler`` capture written as a Chrome trace (open it in Perfetto or
``chrome://tracing``); and the card-side helpers the kernel timings share:
``nvidia_smi_line``, ``event_ms``, ``device_ms``. On a CUDA device a stage synchronises the card when it
begins and when it ends, so its figure is the device work queued inside it
plus the Python cost of queueing it; the JAX package waits for its
dispatches at the stage's end in the same way.

``span(name, n=None, size=None)`` marks a phase of the serving path
(``register``, ``track_one`` and what they call). It is on exactly while a
``torch.profiler`` session records: then it opens a
``torch.profiler.record_function(name)`` range, so the phase lies in the
profiler's trace on the clock of the kernels and runtime calls it launches,
and keeps one record in memory (``records()``, ``summary()``; ``trace``
writes them to ``spans.json``). Otherwise it costs one check and records
nothing. A span never synchronises and never reads a device value: ``n``
(the batch it covers: hypotheses, crop pairs) and ``size`` (a crop's side)
come from shapes; entering a span gives its record (None while no profiler
records), whose ``n`` may be set inside the span once it is known. A name
ending in ``.wait`` marks a host read of a device value, where the host waits
for the card.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import subprocess
import tempfile
import threading
import time
from collections import defaultdict

import torch

from foundationpose_tpu_torch import resolve_device

_PROFILER_SESSIONS = 3  # profiler sessions device_ms takes at most

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()  # what a span is while no profiler records
_RECORDS = []  # one dict per span entered while a profiler recorded
_CALL_IDS = itertools.count()
_OPEN = threading.local()  # .stack: this thread's open span records, innermost last


def span(name, n=None, size=None):
    """Context manager round one phase: a ``record_function(name)`` range
    and a record while a profiler records, else a shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, n, size)


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name, n, size):
        self.rec = {"name": name, "n": n, "size": size}

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        rec = self.rec
        parent = stack[-1] if stack else None
        rec["id"] = len(_RECORDS)
        rec["parent"] = parent["id"] if parent else None
        rec["call"] = parent["call"] if parent else next(_CALL_IDS)
        _RECORDS.append(rec)
        stack.append(rec)
        # the host interval holds the range's own cost, so it is charged to
        # this span and not to its parent's self time
        rec["start_ns"] = time.perf_counter_ns()
        self.range = torch.profiler.record_function(rec["name"])
        self.range.__enter__()
        return rec

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.rec["end_ns"] = time.perf_counter_ns()
        _OPEN.stack.pop()
        return False


def records():
    """The span records kept since the last ``reset()``, in the order the
    spans were entered: ``name``, ``id`` (its index here), ``parent`` (the
    enclosing span's id, or None), ``call`` (shared by every span of one
    outermost span: one ``register`` or ``track_one`` call), ``start_ns`` /
    ``end_ns`` (``time.perf_counter_ns``), ``n`` and ``size``."""
    return _RECORDS


def reset():
    """Forget the records (between profiler sessions, not inside a span)."""
    _RECORDS.clear()


def summary(recs=None):
    """Per span name: ``calls``, ``total_ms`` and ``self_ms`` of host time
    (self: the duration less its child spans'), and ``n`` (the sum of the
    batches it covered, None where no span of the name gave one)."""
    recs = _RECORDS if recs is None else recs
    child_ns = defaultdict(int)
    for r in recs:
        if r["parent"] is not None:
            child_ns[r["parent"]] += r["end_ns"] - r["start_ns"]
    out = {}
    for r in recs:
        s = out.setdefault(r["name"], {"calls": 0, "total_ms": 0.0, "self_ms": 0.0, "n": None})
        dur = r["end_ns"] - r["start_ns"]
        s["calls"] += 1
        s["total_ms"] += dur / 1e6
        s["self_ms"] += (dur - child_ns[r["id"]]) / 1e6
        if r["n"] is not None:
            s["n"] = (s["n"] or 0) + r["n"]
    return out


class StageTimer:
    """Accumulating wall-clock timer: ``with timer("render"): ...``.
    ``device=None`` means cuda; ``sync=False`` times the host's enqueue only."""

    def __init__(self, sync=True, device=None):
        self.totals = defaultdict(float)  # seconds per stage
        self.counts = defaultdict(int)
        self.device = resolve_device(device)
        self.sync = sync and self.device.type == "cuda"
        self._depth = 0  # wrapped calls in progress (see ``wrap``)

    def _barrier(self):
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name):
        self._barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._barrier()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def wrap(self, owner, attr, name):
        """Replace ``owner.attr`` by the same function timed as stage
        ``name``. A call made inside another call this timer wrapped is not
        counted again. Returns the function that puts the original back."""
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                with self(name):
                    return fn(*args, **kwargs)
            finally:
                self._depth -= 1

        setattr(owner, attr, timed)
        return lambda: setattr(owner, attr, fn)

    @property
    def ms(self):
        """Milliseconds per stage."""
        return {name: s * 1e3 for name, s in self.totals.items()}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self, reset=False):
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot:.3f}s total, {tot / n * 1000:.1f}ms avg x{n}")
        out = "\n".join(lines)
        logging.info("stage timings:\n%s", out)
        if reset:
            self.reset()
        return out


@contextlib.contextmanager
def trace(log_dir=None, device=None):
    """Profile the block (host operators, and the card's kernels on a CUDA
    device) and write ``trace.json`` into ``log_dir`` (default: a folder in
    the temporary directory), and beside it ``spans.json``: the block's span
    records (``records()``, emptied when the block starts) and their
    ``summary()``. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "foundationpose_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    reset()
    with profile(activities=activities) as prof:
        yield log_dir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"summary": summary(), "records": records()}, f)
    logging.info("profiler trace written to %s", log_dir)


def nvidia_smi_line():
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the first card). Raises when nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm call,
    from CUDA events round the whole run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, kernel_names):
    """Device time per launch of the named kernels over ``reps`` calls of
    ``fn``, from the profiler's kernel records (no host time in it). A
    session that recorded none of a kernel's launches is taken again, up to
    ``_PROFILER_SESSIONS`` sessions in all (in a long process on the H100
    every other session came back empty); None for a kernel no session saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = dict.fromkeys(kernel_names)
    for _ in range(_PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for name in kernel_names:
                if name in e.key and e.count:
                    out[name] = e.self_device_time_total / e.count / 1e3
        if all(v is not None for v in out.values()):
            break
    return out
