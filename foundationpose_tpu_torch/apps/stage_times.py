"""Where the time goes: the engine's own spans over one warm ``register``
and one ``track_one`` on the demo scene, on the GPU.

``--mode geometric`` times the geometric mode (10 + 8 ICP iterations), and
``--funnel`` the documented funnel schedule (top 64 after one coarse iteration
at 112 px) of the learned mode.

After the wall times of untraced calls, each of the two calls runs once
under ``utils/profiling.trace``, which writes the Chrome trace and the span
records (``trace.json``, ``spans.json``) into
``<temporary directory>/foundationpose_trace/<call>``, and its
``profiling.summary()`` is printed: per span (preprocess, each refine
iteration, the crops' render and observed side, the nets, the ICP solve,
each score, the polish, K1's launches, the host's waits) the calls, the host
ms in and under it (``total_ms``) and in it alone (``self_ms``), and the
batch it covered. Nothing synchronises between spans; the device time of
each span is in the trace.

``--train`` times a training step instead, for the refiner (batch 32) and
the scorer (16 hypotheses), 160 px, float32, on an 8-mesh corpus at the
trainer's 2048-face cap: data generation (the three render calls of K1s +
K1r, and the rest — pose draws, augmentation, normalisation), forward (net
and loss), backward and the optimiser, each between two synchronisations,
beside the unwrapped step rate and the device's busy share.

``--slam`` times the online model-free tracker at ``OnlineConfig()`` on the
demo L-shape rendered at 480x640 along an orbit: a tracker ``step``
(depth preprocessing, the K1s + K1r render of each ICP iteration, the
observed warp, the ICP solve), a ``retrain`` (scene bounds, the field's 300
steps, mesh extraction) and a pose-graph BA round (the host problem build,
the Gauss-Newton iterations on the device).

``--field [--encoder hash]`` times one full-width step of the neural object
field (``FieldConfig()``: 2048 rays x (128 + 128) samples) on a synthetic
sphere scene: the ray draw and gather, sampling, the encoder's forward, the
MLP's forward, the rest of the loss, the backward, and each of the two
optimisers, beside the unwrapped step rate (rays/s), the device's busy share
and the kernel count of one step from the profiler.

Usage: python -m foundationpose_tpu_torch.apps.stage_times [--mode geometric] [--funnel]
       [--train] [--field [--encoder hash]] [--slam]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from foundationpose_tpu_torch.utils import profiling
from foundationpose_tpu_torch.utils.profiling import StageTimer


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(name, total_ms, unwrapped_ms, timer):
    rows = {k: {"ms": v, "calls": timer.counts[k], "share": v / total_ms}
            for k, v in sorted(timer.ms.items(), key=lambda kv: -kv[1])}
    other = total_ms - sum(timer.ms.values())
    rows["other"] = {"ms": other, "calls": None, "share": other / total_ms}
    print(json.dumps({"call": name, "wall_ms_with_stage_syncs": total_ms,
                      "wall_ms_unwrapped": unwrapped_ms, "stages": rows}), flush=True)


def busy_share(fn):
    """Wall ms of ``fn`` under the profiler, the device's busy ms (kernel
    rows only: operator rows repeat their kernels' time) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(fn)
    ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall, "device_busy_ms": dev_us / 1e3,
            "device_busy_share": dev_us / 1e3 / wall,
            "device_kernels": sum(e.count for e in ev),
            "top_device": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                            "count": e.count} for e in top]}


def train_stage_times(card, n_meshes=8, steps=20, warm=5, input_size=160, device="cuda"):
    """Stage times of the corpus trainer's step (refiner, then scorer)."""
    import numpy as np

    from foundationpose_tpu_torch.apps.train_agnostic import K_TRAIN
    from foundationpose_tpu_torch.models import agnostic, convert, datagen, training
    from foundationpose_tpu_torch.models.refine_net import RefineNet
    from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

    prepped = agnostic.prepare_corpus(n_meshes, seed=7, max_faces=2048, device=device)
    K = torch.as_tensor(K_TRAIN, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    pick = np.random.default_rng(0)
    kinds = {
        "refiner": (RefineNet(c_in=6), 32, 2e-4,
                    lambda p: datagen.make_refine_batch(gen, p["mt"], K, p["diameter"], batch=32,
                                                        input_size=input_size, augment=True),
                    lambda net, d, p: training.refiner_loss(net, d, p["diameter_t"])),
        "scorer": (ScoreNetMultiPair(c_in=6, norm="group", residual_attn=True), 16, 5e-4,
                   lambda p: datagen.make_score_batch(gen, p["mt"], K, p["diameter"], p["pts"],
                                                      n_hyp=16, input_size=input_size,
                                                      augment=True),
                   lambda net, d, p: training.scorer_loss(net, d)),
    }
    for p in prepped:
        p["diameter_t"] = torch.tensor(p["diameter"], dtype=torch.float32, device=device)
    for name, (net, batch, lr, make, loss_fn) in kinds.items():
        net = convert.flax_init(net, 0).to(device)
        opt = agnostic.corpus_optimizer(net, lr, 20000)

        def step(p, timer=None):
            def stage(label, fn):
                if timer is None:
                    return fn()
                with timer(label):
                    return fn()

            for q in opt.params:
                q.grad = None
            data = stage("data", lambda: make(p))
            loss = stage("forward (net + loss)", lambda: loss_fn(net, data, p))
            stage("backward", loss.backward)
            stage("optimiser", opt.step)
            return loss.detach()

        meshes = [prepped[i] for i in pick.integers(0, len(prepped), warm + 2 * steps)]
        for p in meshes[:warm]:  # warm-up: cuDNN algorithm choice, allocator
            step(p)
        unwrapped = wall_ms(lambda: [step(p) for p in meshes[warm:warm + steps]])
        t = StageTimer(device=device)
        undo = t.wrap(datagen.raster_cuda, "render_crops", "data: render (K1s + K1r)")
        timer = StageTimer(device=device)
        try:
            wrapped = wall_ms(lambda: [step(p, timer) for p in meshes[warm + steps:]])
        finally:
            undo()
        rows = {"data: render (K1s + K1r)": t.ms["data: render (K1s + K1r)"] / steps,
                "data: other (draws, augmentation, normalisation)":
                    (timer.ms["data"] - t.ms["data: render (K1s + K1r)"]) / steps}
        rows.update({k: v / steps for k, v in timer.ms.items() if k != "data"})
        print(json.dumps({
            "call": f"{name} train step (batch {batch}, {input_size} px, float32)",
            "card": card, "steps": steps, "render_calls_per_step":
                t.counts["data: render (K1s + K1r)"] / steps,
            "ms_per_step_unwrapped": unwrapped / steps,
            "steps_per_s_unwrapped": steps / (unwrapped / 1e3),
            "ms_per_step_with_stage_syncs": wrapped / steps,
            "stages_ms_per_step": rows,
            "profiled_step": busy_share(lambda: step(meshes[-1])),
        }), flush=True)


def field_scene(n_frames=4, hw=(120, 160)):
    """The field bench's scene (bench.py:431-452): a 0.5 m sphere 1.2 m in
    front of ``n_frames`` identical cameras. Returns NeRFRunner's inputs."""
    import numpy as np

    H, W = hw
    K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]])
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    dirs = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)], -1)
    o = np.array([0.0, 0.0, -1.2])
    a, b = (dirs * dirs).sum(-1), 2 * (dirs * o).sum(-1)
    disc = b * b - 4 * a * ((o * o).sum() - 0.5**2)
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
    depth = np.where(hit & (t > 0), t, 0).astype(np.float32)
    rgbs = np.tile((0.5 * hit[..., None]).astype(np.float32)[None], (n_frames, 1, 1, 3))
    depths = np.tile(depth[None], (n_frames, 1, 1))
    masks = np.tile(hit[None].astype(np.uint8), (n_frames, 1, 1))
    poses = np.tile(np.eye(4)[None], (n_frames, 1, 1))
    poses[:, :3, 3] = o
    occ = np.random.default_rng(0).uniform(-0.6, 0.6, (2048, 3))
    return rgbs, depths, masks, poses, K, occ, 1.0, np.zeros(3)


def field_stage_times(card, encoder="triplane", steps=20, warm=10, device="cuda"):
    """Stage times of one field train step at ``FieldConfig()`` widths."""
    from foundationpose_tpu_torch.field import runner as runner_mod
    from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner

    cfg = FieldConfig(encoder=encoder)
    r = NeRFRunner(cfg, *field_scene(), device=device)
    f = r.field

    def step(timer=None):
        def stage(label, fn):
            if timer is None:
                return fn()
            with timer(label):
                return fn()

        f.zero_grad(set_to_none=True)
        draws = stage("ray draw + gather", r.draw)
        batch = stage("ray draw + gather", lambda: r.rays[draws["ids"]])
        loss, _ = stage("forward: the rest of the loss", lambda: r.loss_fn(batch, draws))
        stage("backward", loss.backward)
        stage("optimiser: field (Adam, eps 1e-15)", r.opt.step)
        stage("optimiser: pose array", r.opt_pose.step)
        return loss.detach()

    for _ in range(warm):
        step()
    unwrapped = wall_ms(lambda: [step() for _ in range(steps)])
    t = StageTimer(device=device)
    undo = [t.wrap(runner_mod.sampling, "sample_rays", "sampling (ray/box, stratified, occupancy)"),
            t.wrap(f.grid, "forward", f"encoder forward ({encoder})"),
            t.wrap(f.mlp, "forward", "MLP forward (sigma + colour)")]
    timer = StageTimer(device=device)
    try:
        wrapped = wall_ms(lambda: [step(timer) for _ in range(steps)])
    finally:
        for u in undo:
            u()
    inner = sum(t.ms.values())
    rows = {k: v / steps for k, v in t.ms.items()}
    for k, v in timer.ms.items():
        rows[k] = (v - inner if k.startswith("forward") else v) / steps
    print(json.dumps({
        "call": f"field train step ({encoder}, {cfg.n_rand} rays x "
                f"({cfg.n_samples} + {cfg.n_samples_around_depth}) samples, float32)",
        "card": card, "steps": steps, "warmup_steps": warm,
        "ms_per_step_unwrapped": unwrapped / steps,
        "rays_per_s_unwrapped": steps * cfg.n_rand / (unwrapped / 1e3),
        "ms_per_step_with_stage_syncs": wrapped / steps,
        "stages_ms_per_step": dict(sorted(rows.items(), key=lambda kv: -kv[1])),
        "profiled_step": busy_share(step),
    }), flush=True)


def slam_stage_times(card, frames=12, device="cuda"):
    """Stage times of the online tracker: steps (no retrain inside them),
    one retrain, three BA rounds."""
    import numpy as np

    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.core.poses import euler_matrix_np
    from foundationpose_tpu_torch.engine import crop, estimator, geometric
    from foundationpose_tpu_torch.evalsuite.scenes import HW_DEFAULT, K_DEFAULT
    from foundationpose_tpu_torch.field import bounds
    from foundationpose_tpu_torch.field.runner import NeRFRunner
    from foundationpose_tpu_torch.ops import raster, raster_cuda
    from foundationpose_tpu_torch.slam import ba
    from foundationpose_tpu_torch.slam.online import ModelFreeTracker, OnlineConfig

    mesh = demo.make_l_shape()
    cams = np.tile(np.eye(4), (frames, 1, 1))
    for i in range(frames):  # the orbit of tests/test_online.py:112-121
        cams[i, :3, :3] = euler_matrix_np(0.0, 0.035 * i, 0.012 * i)[:3, :3]
        cams[i, :3, 3] = cams[i, :3, :3] @ np.array([0.0, 0.0, -0.45])
    out = raster_cuda.render_full_frame(raster.make_mesh_tensors(mesh, device=device),
                                        np.linalg.inv(cams).astype(np.float32), K_DEFAULT,
                                        HW_DEFAULT, use_light=False)
    rgbs = (out["rgb"].cpu().numpy() * 255).astype(np.float32)
    depths = out["depth"].cpu().numpy()
    masks = out["mask"].cpu().numpy().astype(np.uint8)
    trk = ModelFreeTracker(K_DEFAULT, OnlineConfig(retrain_every_keyframes=10**6), device=device)
    trk.init(rgbs[0], depths[0], masks[0])
    warm = 3
    for f in range(1, warm):
        trk.step(rgbs[f], depths[f], mask=masks[f])
    half = (frames + warm) // 2
    unwrapped = [wall_ms(lambda: trk.step(rgbs[f], depths[f], mask=masks[f]))
                 for f in range(warm, half)]
    t = StageTimer(device=device)
    undo = [t.wrap(estimator, "preprocess_depth", "preprocess (erode+bilateral+xyz)"),
            t.wrap(crop.raster_cuda, "setup_cuda", "render: K1s (face setup + tile bins)"),
            t.wrap(crop.raster_cuda, "rasterize_cuda", "render: K1r (rasterizer)"),
            t.wrap(crop.imops, "warp_crop_affine", "observed warp"),
            t.wrap(geometric, "_point_to_plane_delta", "ICP solve (normal equations + 6x6 solve)")]
    try:
        total = sum(wall_ms(lambda: trk.step(rgbs[f], depths[f], mask=masks[f]))
                    for f in range(half, frames))
    finally:
        for u in undo:
            u()
    n = frames - half
    report(f"tracker step (4 ICP iterations, B=1 x 160 px), mean of {n}", total / n,
           float(np.mean(unwrapped)), _per_call(t, n))
    for label, owner_attrs in (
            ("retrain (FieldConfig(n_step=300)) on %d keyframes" % len(trk.keyframes),
             [(bounds, "compute_scene_bounds", "scene bounds (host)"),
              (NeRFRunner, "train", "field training, 300 steps"),
              (NeRFRunner, "extract_mesh", "mesh extraction (marching tetrahedra)")]),
            ("pose-graph BA round (512 landmarks), mean of 3",
             [(ba, "build_ba_problem", "problem build (host numpy)"),
              (ba, "bundle_adjust", "Gauss-Newton, 8 iterations (device)")])):
        t = StageTimer(device=device)
        undo = [t.wrap(o, a, name) for o, a, name in owner_attrs]
        try:
            if label.startswith("retrain"):
                total, n = wall_ms(trk.retrain), 1
            else:
                total, n = wall_ms(lambda: trk.run_pose_graph_ba(rounds=3)), 3
        finally:
            for u in undo:
                u()
        report(label, total / n, None, _per_call(t, n))
    print(json.dumps({"card": card, "keyframes": len(trk.keyframes)}), flush=True)


def _per_call(timer, n):
    """The timer's stages divided by ``n`` calls (a view ``report`` reads)."""
    t = StageTimer(device=timer.device)
    for k, v in timer.totals.items():
        t.totals[k], t.counts[k] = v / n, timer.counts[k] / n
    return t


def main(argv=None):
    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig

    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["learned", "geometric"], default="learned")
    p.add_argument("--funnel", action="store_true",
                   help="funnel_top_k=64, funnel_coarse_iterations=1, funnel_coarse_size=112")
    p.add_argument("--train", action="store_true",
                   help="time a training step of each net instead of the serving calls")
    p.add_argument("--field", action="store_true",
                   help="time a neural-object-field train step at FieldConfig() widths")
    p.add_argument("--encoder", choices=["triplane", "hash"], default="triplane",
                   help="the field's positional encoder (with --field)")
    p.add_argument("--slam", action="store_true",
                   help="time the online tracker's step, retrain and pose-graph BA round")
    opts = p.parse_args(argv)
    if opts.slam:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__, "slam": True}), flush=True)
        slam_stage_times(card)
        return
    if opts.field:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__, "field": opts.encoder}),
              flush=True)
        field_stage_times(card, opts.encoder)
        return
    if opts.train:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__, "train": True}), flush=True)
        train_stage_times(card)
        return
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
    est.track_one(frames[0][1], frames[0][2], scene["K"])  # warm-up
    # the spread of the untraced calls: 5 registers, 4 passes over 5 frames
    reg_runs = [wall_ms(lambda: est.register(*args)) for _ in range(5)]
    start = est.pose_last.copy()
    trk_runs = []
    for _ in range(4):
        est.pose_last = start
        for _, rgb_f, depth_f in frames[:5]:
            trk_runs.append(wall_ms(lambda: est.track_one(rgb_f, depth_f, scene["K"])))
    print(json.dumps({"call": "untraced repeats", "register_ms": sorted(reg_runs),
                      "track_one_ms_min": min(trk_runs),
                      "track_one_ms_median": sorted(trk_runs)[len(trk_runs) // 2],
                      "track_one_ms": trk_runs}), flush=True)
    _, rgb_f, depth_f = frames[5]  # the frame after the last one tracked
    for name, label, call in (
            ("register", f"register ({opts.mode}, 252 hyps, 160 px, {schedule})",
             lambda: est.register(*args)),
            ("track_one", f"track_one ({opts.mode}, 8 hyps, 2 it)",
             lambda: est.track_one(rgb_f, depth_f, scene["K"]))):
        log_dir = os.path.join(tempfile.gettempdir(), "foundationpose_trace", name)
        with profiling.trace(log_dir):
            traced = wall_ms(call)
        print(json.dumps({"call": label, "wall_ms_traced": traced, "trace": log_dir,
                          "spans": profiling.summary()}), flush=True)


if __name__ == "__main__":
    main()
