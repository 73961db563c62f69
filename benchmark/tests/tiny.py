"""A small copy of the benchmark's cells for the CPU: 120x160 frames, 32 px
crops, 84 hypotheses, few iterations; the same files, found the same way."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

CAMERA = {"height": 120, "width": 160, "fx": 150.0, "fy": 150.0, "cx": 80.0, "cy": 60.0}
ESTIMATOR = {"min_n_views": 4, "inplane_step": 360, "register_iterations": 2,
             "final_refine_iterations": 1, "final_refine_top_k": 4, "track_crop_size": 96}
# The engine and the reference compute alike in float32 on the CPU, so a
# sound run reads 0 on every number here; these limits only have to sit
# above 0 and below what the control and the faults read.
LIMITS = {"learned.register": {"refine_gap_p75_mm": 0.01, "score_gap_median": 1e-4,
                              "answer_gap_m": 0.0},
          "geometric.register": {"icp_step_gap_p99_mm": 0.01, "score_gap": 1e-4,
                                 "answer_gap_m": 0.0},
          "learned.track": {"refine_gap_p75_mm": 0.01, "score_gap_median": 1e-4,
                            "answer_gap_m": 0.0}}
TRAFFIC = {"register_pool16": {"pool": 3, "warm_calls": 1, "trace_calls": 1, "check_calls": 1},
           "track_orbit240": {"pool": 8, "warm_calls": 1, "trace_calls": 2, "check_calls": 2}}


def make(tmp):
    """A benchmark tree under ``tmp`` (BENCHMARK.json + benchmark/) whose
    configurations and traffic are cut to CPU size. Returns its bench dir."""
    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    for name in ("weights", "foundationpose_tpu_torch"):
        os.symlink(os.path.join(ROOT, name), os.path.join(tmp, name))
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["camera"], cfg["input_size"] = CAMERA, 32
        cfg["estimator"].update(ESTIMATOR)
        if cfg["mode"] == "geometric":
            cfg["estimator"].update(register_iterations=2, final_refine_iterations=1)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, over in TRAFFIC.items():
        path = os.path.join(bench, "traffic", name + ".json")
        with open(path) as f:
            tr = json.load(f)
        tr.update(over)
        with open(path, "w") as f:
            json.dump(tr, f)
    for name, limits in LIMITS.items():
        with open(os.path.join(bench, "limits", name + ".json"), "w") as f:
            json.dump(limits, f)
    return bench
