"""Single-frame 6D pose estimation CLI (learned mode).

Counterpart of foundationpose_tpu/apps/run_pose.py for ``--mode learned``
with the shipped ``weights/agnostic`` checkpoint and the hybrid scorer: load
RGB + depth + intrinsics + mesh + mask, run registration, save the pose.
Geometric mode, ``--weights`` checkpoint import, interactive / prompted
masks, visualisation and NetworkTables publishing belong to later slices of
the port and are refused here.

Usage:
  python -m foundationpose_tpu_torch.apps.run_pose --rgb rgb.png \\
      --depth depth.npy --intrinsics cam_K.txt --mesh object.obj \\
      --mask mask.png [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="FoundationPose (PyTorch port): single-frame registration")
    p.add_argument("--rgb", required=True, help="path to rgb image (png/jpg)")
    p.add_argument("--depth", required=True, help="depth: .npy in metres or 16-bit png in millimetres")
    p.add_argument("--intrinsics", required=True, help="cam_K.txt (3x3)")
    p.add_argument("--mesh", required=True, help="object mesh (.obj/.ply)")
    p.add_argument("--mask", required=True, help="object mask image (non-zero = object)")
    p.add_argument("--est-refine-iter", type=int, default=5)
    p.add_argument("--mode", choices=["learned", "geometric"], default="learned")
    p.add_argument("--weights", default=None,
                   help="torch-checkpoint import (not ported yet)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out-dir", default="./pose_out")
    return p


def load_inputs(args):
    from PIL import Image

    rgb = np.asarray(Image.open(args.rgb).convert("RGB"))
    if args.depth.endswith(".npy"):
        depth = np.load(args.depth).astype(np.float32)
    else:
        depth = np.asarray(Image.open(args.depth)).astype(np.float32) / 1000.0
    K = np.loadtxt(args.intrinsics).reshape(3, 3)
    mask = np.asarray(Image.open(args.mask))
    if mask.ndim == 3:
        mask = mask[..., 0]
    return rgb, depth, K, mask > 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")
    if args.mode != "learned":
        raise NotImplementedError(
            "--mode geometric comes with the geometric (ICP) slice of the port"
        )
    if args.weights is not None:
        raise NotImplementedError(
            "--weights torch-checkpoint import comes with the training-stack "
            "slice of the port; the shipped weights/agnostic checkpoint is used"
        )

    from foundationpose_tpu_torch.apps.demo_synthetic import build_estimator
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig

    os.makedirs(args.out_dir, exist_ok=True)
    rgb, depth, K, mask = load_inputs(args)
    mesh = meshio.load_mesh(args.mesh)
    cfg = EstimatorConfig(register_iterations=args.est_refine_iter)
    est = build_estimator(mesh, device=args.device, config=cfg)
    pose = est.register(K, rgb.astype(np.float32), depth, mask,
                        iteration=args.est_refine_iter)
    np.savetxt(os.path.join(args.out_dir, "pose.txt"), pose)
    logging.info("pose:\n%s", pose)
    return pose


if __name__ == "__main__":
    main()
