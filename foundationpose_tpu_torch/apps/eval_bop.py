"""BOP-suite evaluation driver: registration / tracking + ADD-S AUC.

Counterpart of foundationpose_tpu/apps/eval_bop.py (same options, same
summary), on the port's engine: ``device=None`` means cuda.

The reference fork is stripped of its ``run_ycb_video.py`` / ``run_linemod.py``
drivers (SURVEY.md note 4); only the readers and metric functions survive
(datareader.py, Utils.py:232-266). This restores the evaluation surface
(SURVEY.md 3.5): iterate a scene, register on the first frame (or every
frame), optionally track, and report ADD / ADD-S / AUC against GT.

    python -m foundationpose_tpu_torch.apps.eval_bop --video-dir $BOP/ycbv/test/000048 \
        --ob-id 1 --mode geometric --track
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="BOP evaluation: register/track + ADD-S AUC")
    p.add_argument("--video-dir", required=True)
    p.add_argument("--ob-id", type=int, default=None)
    p.add_argument("--mode", choices=["learned", "geometric"], default="geometric")
    p.add_argument("--weights", default=None)
    p.add_argument("--track", action="store_true",
                   help="register on frame 0, track the rest (video protocol)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--est-refine-iter", type=int, default=5)
    p.add_argument("--track-refine-iter", type=int, default=2)
    p.add_argument("--out", default=None, help="write per-frame results json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def evaluate_scene(reader, ob_id, mode="geometric", weights=None, track=False,
                   max_frames=None, stride=1, est_refine_iter=5,
                   track_refine_iter=2, estimator_config=None,
                   geometric_config=None, device=None):
    """``estimator_config`` / ``geometric_config``: optional overrides for the
    engine configuration (tests and small scenes use reduced hypothesis grids
    and crop sizes; None = the full defaults). ``weights``: a directory with
    torch ``refiner.pth`` / ``scorer.pth`` for learned mode."""
    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.core import metrics
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch

    device = resolve_device(device)

    mesh = reader.get_gt_mesh(ob_id)
    symmetry_tfs = reader.symmetry_tfs.get(ob_id) if hasattr(reader, "symmetry_tfs") else None

    if mode == "geometric":
        from foundationpose_tpu_torch.engine.geometric import (
            GeometricConfig, GeometricRefiner, GeometricScorer,
        )

        cfg = estimator_config or EstimatorConfig(
            register_iterations=max(est_refine_iter * 2, 10),
            final_refine_iterations=8,
        )
        gcfg = geometric_config or GeometricConfig()
        est = FoundationPoseTorch(
            mesh, symmetry_tfs=symmetry_tfs, config=cfg,
            refiner=GeometricRefiner(gcfg, device),
            scorer=GeometricScorer(gcfg, device), device=device,
        )
    else:
        cfg = estimator_config or EstimatorConfig(
            register_iterations=est_refine_iter
        )
        est = FoundationPoseTorch(mesh, symmetry_tfs=symmetry_tfs, config=cfg, device=device)
        if weights:
            from foundationpose_tpu_torch.models.weights import load_engine_params

            load_engine_params(est, weights)

    frame_ids = list(range(0, len(reader.color_files), stride))
    if max_frames:
        frame_ids = frame_ids[:max_frames]

    results = []
    for n, i in enumerate(frame_ids):
        rgb = reader.get_color(i)
        depth = reader.get_depth(i)
        K = reader.get_K(i)
        mask = reader.get_mask(i, ob_id)
        if mask is None or mask.sum() < 50:
            logging.info("frame %d: no mask, skipping", i)
            continue
        gt = reader.get_gt_pose(i, ob_id, mask=mask)

        if track and n > 0 and est.pose_last is not None:
            pose = est.track_one(rgb.astype(np.float32), depth, K,
                                 iteration=track_refine_iter)
        else:
            pose = est.register(K, rgb.astype(np.float32), depth, mask)

        add = float(metrics.add_err(pose, gt, mesh.vertices))
        adds = float(metrics.adds_err(pose, gt, mesh.vertices))
        results.append({"frame": int(i), "add": add, "adds": adds})
        logging.info("frame %d: ADD=%.4f ADD-S=%.4f", i, add, adds)

    adds_errs = [r["adds"] for r in results]
    add_errs = [r["add"] for r in results]
    summary = {
        "n_frames": len(results),
        "adds_auc": metrics.compute_auc(adds_errs) if results else 0.0,
        "add_auc": metrics.compute_auc(add_errs) if results else 0.0,
        "adds_mean": float(np.mean(adds_errs)) if results else -1.0,
        "frames": results,
    }
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")
    from foundationpose_tpu_torch.io.datareader import get_bop_reader

    reader = get_bop_reader(args.video_dir)
    ob_id = args.ob_id or int(reader.get_instance_ids_in_image(0)[0])
    summary = evaluate_scene(
        reader, ob_id, mode=args.mode, weights=args.weights, track=args.track,
        max_frames=args.max_frames, stride=args.stride,
        est_refine_iter=args.est_refine_iter,
        track_refine_iter=args.track_refine_iter, device=args.device,
    )
    print(json.dumps({k: v for k, v in summary.items() if k != "frames"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
