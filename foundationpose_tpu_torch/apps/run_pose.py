"""Single-frame 6D pose estimation CLI.

Counterpart of foundationpose_tpu/apps/run_pose.py (reference main.py, call
stack SURVEY.md 3.1), option for option and with the same defaults, plus
``--device``: load RGB + depth + intrinsics (3x3 or ZED conf) + mesh, obtain
the object mask (a file, ``--manual-mask`` painted interactively,
``--prompt`` through the detector + segmenter, or ``--box`` from an upstream
detector through the port's SAM, ``detect/segmenter.BoxSegmenter``, whose
mask stays on the device), register, save the pose and,
at ``--debug >= 1``, ``vis.png``; convert the pose to 6D robot coordinates and
publish it to NetworkTables when asked.

``--mode geometric`` (the default) needs no weights: projective ICP +
geometric score, twice the refine iterations and an 8-iteration polish.
``--mode learned`` uses the shipped object-agnostic checkpoint
(``weights/agnostic``) with the hybrid scorer, or the weights given by
``--weights``: an engine checkpoint file (``models/checkpoint.save_engine``)
or a directory of ``refiner.pth`` / ``scorer.pth`` (torch) or ``.msgpack``
(flax) files.

One difference from the JAX CLI: ``--debug`` also reaches the engine, which
writes its own dumps into ``--out-dir`` (``vis_register.png``; at 2 the
render | observed canvas of the top hypotheses; at 3 one canvas per refine
iteration).

Usage:
  python -m foundationpose_tpu_torch.apps.run_pose --rgb rgb.png \\
      --depth depth.png --intrinsics cam_K.txt --mesh object.obj \\
      --mask mask.png [--mode learned] [--debug 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="FoundationPose (PyTorch port): single-frame registration")
    p.add_argument("--rgb", required=True, help="path to rgb image (png/jpg)")
    p.add_argument("--depth", required=True, help="path to depth (npy meters or png mm)")
    p.add_argument("--intrinsics", required=True, help="cam_K.txt (3x3 or ZED conf format)")
    p.add_argument("--mesh", required=True, help="object mesh (.obj/.ply)")
    p.add_argument("--mask", default=None, help="object mask file; omit for --manual-mask or --prompt")
    p.add_argument("--manual-mask", action="store_true", help="paint the mask interactively")
    p.add_argument("--prompt", default=None, help="text prompt for detector+segmenter auto-masking")
    p.add_argument("--box", default=None,
                   help="x0,y0,x1,y1: a detector's box in pixels, masked by SAM from $SAM_PATH "
                        "(a segment_anything .pth or a HuggingFace SAM directory)")
    p.add_argument("--est-refine-iter", type=int, default=5)
    p.add_argument("--mode", choices=["learned", "geometric"], default="geometric",
                   help="refiner/scorer backend; 'learned' uses weights/agnostic or --weights")
    p.add_argument("--weights", default=None,
                   help="engine checkpoint file (save_engine), or a directory with "
                        "refiner/scorer .pth (torch) or .msgpack (flax) files")
    p.add_argument("--out-dir", default="./pose_out")
    p.add_argument("--debug", type=int, default=1)
    p.add_argument("--nt-server", default=None, help="publish pose to this NetworkTables server")
    p.add_argument("--to-inches", action="store_true", default=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def get_mask(args, rgb, depth):
    """The object mask from a file, the interactive painter or a prompt."""
    if args.mask:
        from foundationpose_tpu_torch.io.masking import load_mask

        return load_mask(args.mask, shape=depth.shape)
    if args.manual_mask:
        from foundationpose_tpu_torch.io.masking import MaskingTool

        mask = MaskingTool().run(rgb, os.path.join(args.out_dir, "mask.png"))
        if mask is None:
            raise SystemExit("masking aborted")
        return mask
    if args.box:
        from foundationpose_tpu_torch.detect.segmenter import BoxSegmenter

        box = [float(v) for v in args.box.split(",")]
        ckpt = os.getenv("SAM_PATH", "")
        if len(box) != 4:
            raise SystemExit(f"--box takes x0,y0,x1,y1, got {args.box!r}")
        if not ckpt or not os.path.exists(ckpt):
            raise SystemExit("--box needs a SAM checkpoint: set SAM_PATH")
        return BoxSegmenter(checkpoint=ckpt, device=args.device)(rgb, box)
    if args.prompt:
        from foundationpose_tpu_torch.detect.pipeline import AutoMasker

        return AutoMasker(device=args.device).mask_from_prompt(rgb, args.prompt)
    raise SystemExit("provide --mask, --manual-mask, --box or --prompt")


def build_engine(args, mesh, device):
    """The estimator of ``--mode``: geometric, or learned with the agnostic
    checkpoint + hybrid scorer unless ``--weights`` names other weights."""
    from foundationpose_tpu_torch.apps.demo_synthetic import default_weights_dir
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch

    debug = dict(debug=args.debug, debug_dir=args.out_dir)
    refiner = scorer = None
    if args.mode == "geometric":
        from foundationpose_tpu_torch.engine.geometric import (
            GeometricConfig, GeometricRefiner, GeometricScorer,
        )

        refiner = GeometricRefiner(GeometricConfig(), device)
        scorer = GeometricScorer(GeometricConfig(), device)
        cfg = EstimatorConfig(register_iterations=args.est_refine_iter * 2,
                              final_refine_iterations=8, **debug)
    else:
        cfg = EstimatorConfig(register_iterations=args.est_refine_iter, **debug)
        agn_dir = default_weights_dir()
        if args.weights is None and os.path.isdir(agn_dir):
            from foundationpose_tpu_torch.engine.scorer import HybridScorer
            from foundationpose_tpu_torch.models.agnostic import load_agnostic

            refiner, learned_scorer, _ = load_agnostic(agn_dir, device=device)
            scorer = HybridScorer(learned_scorer)
            logging.info("learned mode: agnostic checkpoint %s + hybrid scorer", agn_dir)
    est = FoundationPoseTorch(mesh, config=cfg, refiner=refiner, scorer=scorer, device=device)
    if args.weights and args.mode == "learned":
        from foundationpose_tpu_torch.models.weights import load_engine_params

        load_engine_params(est, args.weights)
    return est


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")

    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.io import png
    from foundationpose_tpu_torch.io.file_loader import FileLoader
    from foundationpose_tpu_torch.io.pose6d import PoseTransformer

    loader = FileLoader()
    rgb = loader.load_rgb_image_from_file(args.rgb)
    depth = loader.load_depth_from_file(args.depth)
    K = loader.load_camera_intrinsics(args.intrinsics)
    if rgb is None or depth is None or K is None:
        raise SystemExit("failed to load inputs")
    mesh = meshio.load_mesh(args.mesh)
    mask = get_mask(args, rgb, depth)

    est = build_engine(args, mesh, resolve_device(args.device))
    pose = est.register(K, rgb.astype(np.float32), depth, mask,
                        iteration=None if args.mode == "geometric" else args.est_refine_iter)
    np.savetxt(os.path.join(args.out_dir, "pose.txt"), pose)
    logging.info("pose:\n%s", pose)

    # center_pose = pose of the centred mesh (reference main.py:67)
    center_pose = pose @ np.linalg.inv(est.get_tf_to_centered_mesh())
    if args.debug >= 1:
        from foundationpose_tpu_torch.utils.vis import draw_posed_3d_box, draw_xyz_axis

        vis = draw_posed_3d_box(K, rgb, center_pose, est.mesh.bounds)
        vis = draw_xyz_axis(vis, center_pose, scale=0.1, K=K)
        png.write_png(os.path.join(args.out_dir, "vis.png"), vis)
        logging.info("visualization saved to %s/vis.png", args.out_dir)

    pose_6d = PoseTransformer(to_inches=args.to_inches).transform_pose(center_pose)
    if args.nt_server:
        from foundationpose_tpu_torch.io.nt import PosePublisher

        PosePublisher(server=args.nt_server).publish_pose(pose_6d)
    return pose


if __name__ == "__main__":
    main()
