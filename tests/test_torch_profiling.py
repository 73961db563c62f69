"""The port's stage timer and profiler trace (``utils/profiling.py``) against
the JAX package's: on the same stages and the same clock readings both give
the same totals, counts and report, to the character."""

import json
import os

import numpy as np
import pytest
import torch

from foundationpose_tpu.utils import profiling as jprofiling
from foundationpose_tpu_torch.utils import profiling


class FakeClock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def drive(timer):
    for name in ("render", "warp", "render", "net", "render", "warp"):
        with timer(name):
            pass
    return timer.report(reset=False)


def test_stage_timer_matches_jax(monkeypatch):
    monkeypatch.setattr(jprofiling.time, "perf_counter", FakeClock(0.0125))
    ref = jprofiling.StageTimer(sync=True)
    ref_report = drive(ref)
    monkeypatch.setattr(profiling.time, "perf_counter", FakeClock(0.0125))
    mine = profiling.StageTimer(device="cpu")
    report = drive(mine)
    assert report == ref_report
    assert dict(mine.counts) == dict(ref.counts) == {"render": 3, "warp": 2, "net": 1}
    assert mine.ms == pytest.approx({k: v * 1e3 for k, v in ref.totals.items()})
    assert mine.report(reset=True) == report and not mine.totals and not mine.counts


def test_wrap_counts_a_nested_call_once(monkeypatch):
    """``wrap`` times a function as a stage; a wrapped call made inside
    another wrapped call of the same timer is not counted again."""

    class Box:
        def inner(self):
            return 1

        def outer(self):
            return self.inner() + 1

    box = Box()
    t = profiling.StageTimer(device="cpu")
    undo = [t.wrap(box, "inner", "inner"), t.wrap(box, "outer", "outer")]
    assert box.outer() == 2 and box.inner() == 1
    assert dict(t.counts) == {"outer": 1, "inner": 1}
    for u in undo:
        u()
    assert "timed" not in box.inner.__qualname__


def test_device_rule_and_trace(tmp_path):
    """``device=None`` means cuda; ``trace`` writes a Chrome trace holding
    the block's operators."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.StageTimer()
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as log_dir:
        a = torch.tensor(np.eye(8, dtype=np.float32))
        (a @ a).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
