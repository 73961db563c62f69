"""Where the time goes: per-stage wall times of one warm ``register`` and of
``track_one`` on the demo scene, on the GPU.

``--mode geometric`` times the geometric mode (10 + 8 ICP iterations), and
``--funnel`` the documented funnel schedule (top 64 after one coarse iteration
at 112 px) of the learned mode.

Each stage function (depth preprocessing, the two kernels of a render call —
K1s and K1r, each with the allocations of its wrapper —, observed warp,
RefineNet forward, ScoreNet forward, or the ICP's solve in geometric mode) is
wrapped with a timer that
synchronises the device before and after, so a stage's figure is device
work plus the Python overhead of launching it. Synchronising serialises host
and device, so the stages sum to somewhat more than an unwrapped call (both
are printed). "other" is what no wrapped stage covers: crop normalisation,
gating, the geometric score's own arithmetic, sorting, uploads.

Usage: python -m foundationpose_tpu_torch.apps.stage_times [--mode geometric] [--funnel]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch


class StageTimer:
    def __init__(self):
        self.ms, self.calls, self._depth = {}, {}, 0

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            if self._depth:  # nested inside another timed stage: no double count
                return fn(*a, **kw)
            self._depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[label] = self.ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
                self.calls[label] = self.calls.get(label, 0) + 1
                self._depth -= 1

        setattr(owner, name, timed)
        return lambda: setattr(owner, name, fn)

    def reset(self):
        self.ms, self.calls = {}, {}


@contextlib.contextmanager
def timed_stages(est):
    from foundationpose_tpu_torch.engine import crop, estimator, geometric

    t = StageTimer()
    undo = [
        t.wrap(estimator, "preprocess_depth", "preprocess (erode+bilateral+xyz)"),
        t.wrap(crop.raster_cuda, "setup_cuda", "render: K1s (face setup + tile bins)"),
        t.wrap(crop.raster_cuda, "rasterize_cuda", "render: K1r (rasterizer)"),
        t.wrap(crop.imops, "warp_crop_affine", "observed warp"),
    ]
    if hasattr(est.refiner, "net"):
        undo += [t.wrap(est.refiner.net, "forward", "RefineNet forward"),
                 t.wrap(est.scorer.net, "forward", "ScoreNet forward")]
    else:
        undo.append(t.wrap(geometric, "_point_to_plane_delta",
                           "ICP solve (normal equations + 6x6 solve + exp map)"))
    try:
        yield t
    finally:
        for u in undo:
            u()


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(name, total_ms, unwrapped_ms, timer):
    rows = {k: {"ms": v, "calls": timer.calls[k], "share": v / total_ms}
            for k, v in sorted(timer.ms.items(), key=lambda kv: -kv[1])}
    other = total_ms - sum(timer.ms.values())
    rows["other"] = {"ms": other, "calls": None, "share": other / total_ms}
    print(json.dumps({"call": name, "wall_ms_with_stage_syncs": total_ms,
                      "wall_ms_unwrapped": unwrapped_ms, "stages": rows}), flush=True)


def main(argv=None):
    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig

    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["learned", "geometric"], default="learned")
    p.add_argument("--funnel", action="store_true",
                   help="funnel_top_k=64, funnel_coarse_iterations=1, funnel_coarse_size=112")
    opts = p.parse_args(argv)
    config = None
    if opts.funnel:
        config = EstimatorConfig(funnel_top_k=64, funnel_coarse_iterations=1,
                                 funnel_coarse_size=112)
        if opts.mode == "geometric":
            config.register_iterations, config.final_refine_iterations = 10, 8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "mode": opts.mode,
                      "funnel": opts.funnel}), flush=True)
    scene = demo.make_scene((480, 640))
    est = demo.build_estimator(scene["mesh"], config=config, mode=opts.mode)
    schedule = (f"{est.cfg.register_iterations}+{est.cfg.final_refine_iterations} it"
                + (", funnel top 64 after 1 coarse it at 112 px" if opts.funnel else ""))
    frames = list(demo.motion_frames(scene, 6))
    args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    est.register(*args)  # warm-up: kernel build, cuDNN algorithm choice
    reg_unwrapped = wall_ms(lambda: est.register(*args))
    est.track_one(frames[0][1], frames[0][2], scene["K"])  # warm-up
    trk_unwrapped = wall_ms(lambda: est.track_one(frames[1][1], frames[1][2], scene["K"]))
    # the spread of the unwrapped calls: 5 registers, 4 passes over 5 frames
    reg_runs = [wall_ms(lambda: est.register(*args)) for _ in range(5)]
    start = est.pose_last.copy()
    trk_runs = []
    for _ in range(4):
        est.pose_last = start
        for _, rgb_f, depth_f in frames[:5]:
            trk_runs.append(wall_ms(lambda: est.track_one(rgb_f, depth_f, scene["K"])))
    print(json.dumps({"call": "unwrapped repeats", "register_ms": sorted(reg_runs),
                      "track_one_ms_min": min(trk_runs),
                      "track_one_ms_median": sorted(trk_runs)[len(trk_runs) // 2],
                      "track_one_ms": trk_runs}), flush=True)
    with timed_stages(est) as t:
        total = wall_ms(lambda: est.register(*args))
        report(f"register ({opts.mode}, 252 hyps, 160 px, {schedule})", total, reg_unwrapped, t)
        for _, rgb_f, depth_f in frames[2:]:
            t.reset()
            total = wall_ms(lambda: est.track_one(rgb_f, depth_f, scene["K"]))
        report(f"track_one ({opts.mode}, 8 hyps, 2 it), last of 4 frames", total, trk_unwrapped, t)

    # device busy share of one warm track_one, from the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(lambda: est.track_one(frames[1][1], frames[1][2], scene["K"]))
    # kernel rows only: operator rows repeat their kernels' device time
    ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in ev)
    n_kern = sum(e.count for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    print(json.dumps({
        "call": "track_one under torch.profiler", "wall_ms": wall,
        "device_busy_ms": dev_us / 1e3, "device_busy_share": dev_us / 1e3 / wall,
        "device_kernels": n_kern,
        "top_device": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in top],
    }), flush=True)


if __name__ == "__main__":
    main()
