"""Video tracking driver for YCBInEOAT-style sequences.

Counterpart of foundationpose_tpu/apps/run_track.py (same options, same
summary), on the port's engine: ``device=None`` means cuda. ``--stream`` (the
default) enqueues ``track_one(sync=False)`` frame after frame and reads the
device-resident poses back only after the loop. ``--weights`` (learned mode)
names an engine checkpoint written by ``models/checkpoint.save_engine``; the
JAX package's orbax directories are not read (carry weights across as an
object-agnostic npz checkpoint).

Upstream FoundationPose ships a ``run_demo.py`` tracking entry; this fork is
stripped to the single-frame ``main.py`` (SURVEY.md note 4) but keeps the
YCBInEOAT reader (reference datareader.py:85-180). This driver restores the
video protocol: register on the first frame from the annotated mask, stream
``track_one`` over the remaining frames (async device-resident pose chain),
and report per-frame ADD / ADD-S against the annotated poses when present.

    python -m foundationpose_tpu_torch.apps.run_track --video-dir <YCBInEOAT/bleach0> \
        --mode geometric --out track.json
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="YCBInEOAT video tracking")
    p.add_argument("--video-dir", required=True)
    p.add_argument("--mesh", default=None,
                   help="object mesh; defaults to the reader's GT mesh")
    p.add_argument("--mode", choices=["learned", "geometric"], default="geometric")
    p.add_argument("--weights", default=None)
    p.add_argument("--est-refine-iter", type=int, default=5)
    p.add_argument("--track-refine-iter", type=int, default=2)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--stream", action=argparse.BooleanOptionalAction, default=True,
                   help="async tracking (device-resident pose chain); "
                        "--no-stream selects the synchronous path")
    p.add_argument("--out", default=None, help="per-frame results json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def track_video(reader, mesh=None, mode="geometric", weights=None,
                est_refine_iter=5, track_refine_iter=2, max_frames=None,
                stream=True, device=None):
    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.core import meshio, metrics
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch

    device = resolve_device(device)

    if mesh is None:
        mesh = reader.get_gt_mesh()
    elif isinstance(mesh, str):
        mesh = meshio.load_mesh(mesh)

    cfg = EstimatorConfig(
        register_iterations=est_refine_iter,
        track_iterations=track_refine_iter,
    )
    if mode == "geometric":
        from foundationpose_tpu_torch.engine.geometric import (
            GeometricConfig, GeometricRefiner, GeometricScorer,
        )

        cfg = EstimatorConfig(
            register_iterations=max(est_refine_iter * 2, 10),
            track_iterations=max(track_refine_iter * 2, 4),
            final_refine_iterations=8,
        )
        est = FoundationPoseTorch(
            mesh, config=cfg,
            refiner=GeometricRefiner(GeometricConfig(), device),
            scorer=GeometricScorer(GeometricConfig(), device), device=device,
        )
    else:
        est = FoundationPoseTorch(mesh, config=cfg, device=device)
        if weights:
            from foundationpose_tpu_torch.models.checkpoint import load_engine

            load_engine(est, weights)

    n = len(reader)
    if max_frames:
        n = min(n, max_frames)
    K = reader.K
    results = []
    pending = []  # (frame index, deferred pose) for the streaming path
    # track_fps covers steady-state tracking only: the timer starts after
    # frame 0's register AND after frame 1's track_one (first-call costs), so
    # short sequences don't report a fps dominated by them
    t_start = None
    n_timed = 0
    for i in range(n):
        rgb = reader.get_color(i)
        depth = reader.get_depth(i)
        if i == 0:
            mask = reader.get_mask(0)
            pose = est.register(K, rgb, depth, mask, iteration=cfg.register_iterations)
            results.append({"i": 0, "pose": pose.tolist()})
        elif stream:
            pending.append((i, est.track_one(rgb, depth, K, sync=False)))
        else:
            pose = est.track_one(rgb, depth, K)
            results.append({"i": i, "pose": pose.tolist()})
        if i == 1:
            t_start = time.perf_counter()
        elif i > 1:
            n_timed += 1
    for i, out in pending:
        results.append({"i": i, "pose": out.cpu().numpy().astype(np.float64).tolist()})
    fps = (
        n_timed / max(time.perf_counter() - t_start, 1e-9)
        if t_start is not None and n_timed > 0
        else None
    )

    # score against annotated poses when available
    for r in results:
        gt = reader.get_gt_pose(r["i"])
        if gt is None:
            continue
        pose = np.asarray(r["pose"])
        r["add"] = float(metrics.add_err(pose, gt, mesh.vertices))
        r["adds"] = float(metrics.adds_err(pose, gt, mesh.vertices))
    adds = [r["adds"] for r in results if "adds" in r]
    pairs = [
        (np.asarray(r["pose"]), reader.get_gt_pose(r["i"]))
        for r in results
        if reader.get_gt_pose(r["i"]) is not None
    ]
    summary = {
        "frames": len(results),
        "track_fps": round(fps, 2) if fps is not None else None,
        "adds_mean": float(np.mean(adds)) if adds else None,
        # threshold recall (fraction of frames with ADD-S < 0.1*diameter) and
        # the real accuracy-threshold AUC (reference Utils.py:255-266)
        "adds_recall_0.1d": (
            float(np.mean(np.asarray(adds) < 0.1 * est.diameter)) if adds else None
        ),
        "adds_auc_0.1": (
            float(metrics.compute_auc(adds, max_val=0.1)) if adds else None
        ),
        # trajectory error vs annotated poses (BundleSDF's headline metric)
        "ate_rmse": (
            metrics.ate_rmse([p for p, _ in pairs], [g for _, g in pairs])
            if len(pairs) >= 3
            else None
        ),
    }
    return results, summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    from foundationpose_tpu_torch.io.datareader import YcbineoatReader

    reader = YcbineoatReader(args.video_dir)
    results, summary = track_video(
        reader, mesh=args.mesh, mode=args.mode, weights=args.weights,
        est_refine_iter=args.est_refine_iter,
        track_refine_iter=args.track_refine_iter,
        max_frames=args.max_frames, stream=args.stream, device=args.device,
    )
    logging.info("summary: %s", summary)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "frames": results}, f)


if __name__ == "__main__":
    main()
