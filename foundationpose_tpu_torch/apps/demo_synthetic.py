"""Self-contained synthetic demo: build a scene, register, track a short
motion — learned-hybrid mode with the shipped object-agnostic checkpoint, or
geometric mode (projective ICP + geometric score, no weights).

Counterpart of foundationpose_tpu/apps/demo_synthetic.py (same chiral
L-shaped object, same pose, same per-frame motion). ``make_scene`` and
``motion_frames`` are shared with ``chip_smoke.py`` at the repository root.

Usage: python -m foundationpose_tpu_torch.apps.demo_synthetic [--device cpu] [--mode geometric]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo, meshio, metrics
from foundationpose_tpu_torch.ops import raster, raster_cuda

# Flat backdrop plane behind the object (metres). It sits within two object
# radii of the object, the range the crop normalisation keeps; over a
# backdrop beyond it (0.9 m) both packages track this object markedly worse
# with the shipped checkpoint (PERF.md, findings of the first port slice).
BACKDROP_Z = 0.7
BACKDROP_RGB = (96, 104, 112)
FRAME_DT = (0.004, -0.002, 0.005)     # per-frame translation (metres)
FRAME_DW = (0.03, 0.02, -0.02)        # per-frame axis-angle rotation (rad)


def make_l_shape():
    """Chiral L-shaped object of three boxes, uniform light-gray colour."""
    boxes = [
        meshio.make_box((0.12, 0.04, 0.04)),
        meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0]),
        meshio.make_box((0.04, 0.04, 0.07)).translated([-0.04, 0.0, 0.055]),
    ]
    verts = np.concatenate([m.vertices for m in boxes])
    offs = np.cumsum([0] + [len(m.vertices) for m in boxes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(boxes, offs)])
    mesh = meshio.Mesh(verts, faces)
    mesh.vertex_colors = np.full((len(verts), 3), 170, np.uint8)
    return mesh


def default_gt_pose():
    gt = np.eye(4)
    gt[:3, :3] = geo.euler_matrix(0.4, -0.25, 0.6)[:3, :3].numpy().astype(np.float64)
    gt[:3, 3] = [0.01, -0.02, 0.55]
    return gt


def default_intrinsics(hw):
    """Pinhole camera whose focal length scales with the image height
    (420 px at 240 rows, 840 px at 480)."""
    H, W = hw
    f = 420.0 * H / 240.0
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])


def render_frame(mesh_tensors, pose, K, hw):
    """Render the object at ``pose`` over a flat backdrop. Returns
    (rgb uint8 (H,W,3), depth float32 (H,W) metres, mask bool (H,W))."""
    out = raster_cuda.render_full_frame(mesh_tensors, np.asarray(pose)[None], K, hw)
    m = out["mask"][0].cpu().numpy()
    rgb = (out["rgb"][0].cpu().numpy() * 255).astype(np.uint8)
    depth = out["depth"][0].cpu().numpy().astype(np.float32)
    rgb[~m] = BACKDROP_RGB
    depth[~m] = BACKDROP_Z
    return rgb, depth, m


def make_scene(hw=(240, 320), device=None):
    """The demo scene: mesh, intrinsics, ground-truth pose and the rendered
    first frame. Returns a dict."""
    device = resolve_device(device)
    mesh = make_l_shape()
    K = default_intrinsics(hw)
    gt = default_gt_pose()
    mt = raster.make_mesh_tensors(mesh, device=device)
    rgb, depth, mask = render_frame(mt, gt, K, hw)
    return {"mesh": mesh, "K": K, "gt": gt, "hw": hw, "mesh_tensors": mt,
            "rgb": rgb, "depth": depth, "mask": mask}


def motion_frames(scene, n_frames):
    """Yield (gt_pose, rgb, depth) for ``n_frames`` of small motion after the
    scene's first frame."""
    cur = scene["gt"].copy()
    dR = geo.so3_exp_map(np.array([FRAME_DW]))[0].numpy().astype(np.float64)
    for _ in range(n_frames):
        cur = cur.copy()
        cur[:3, 3] += FRAME_DT
        cur[:3, :3] = dR @ cur[:3, :3]
        rgb, depth, _ = render_frame(scene["mesh_tensors"], cur, scene["K"], scene["hw"])
        yield cur, rgb, depth


def default_weights_dir():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "weights", "agnostic")


def build_estimator(mesh, device=None, config=None, input_size=None, mode="learned"):
    """``mode="learned"``: agnostic RefineNet + ScoreNet checkpoint with
    ``HybridScorer`` (weight 2.0). ``mode="geometric"``: ``GeometricRefiner``
    + ``GeometricScorer``; without a ``config`` it gets the schedule of
    ``run_pose --mode geometric`` (10 ICP iterations, then 8 more on the top
    8)."""
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch

    device = resolve_device(device)
    if mode == "geometric":
        from foundationpose_tpu_torch.engine.geometric import (
            GeometricConfig, GeometricRefiner, GeometricScorer,
        )

        gcfg = GeometricConfig(input_size=input_size) if input_size else GeometricConfig()
        refiner, scorer = GeometricRefiner(gcfg, device), GeometricScorer(gcfg, device)
        config = config or EstimatorConfig(register_iterations=10, final_refine_iterations=8)
    elif mode == "learned":
        from foundationpose_tpu_torch.engine.scorer import HybridScorer
        from foundationpose_tpu_torch.models.agnostic import load_agnostic

        refiner, learned, _ = load_agnostic(
            default_weights_dir(), device=device, input_size=input_size
        )
        scorer = HybridScorer(learned)
    else:
        raise ValueError(f"mode must be 'learned' or 'geometric', got {mode!r}")
    return FoundationPoseTorch(
        mesh, config=config, refiner=refiner, scorer=scorer, device=device
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--frames", type=int, default=5, help="tracking frames after register")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--mode", choices=["learned", "geometric"], default="learned")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    scene = make_scene((args.height, args.width), device=device)
    est = build_estimator(scene["mesh"], device=device, mode=args.mode)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = clock()
    pose = est.register(scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    t_reg = clock() - t0
    err = metrics.adds_err(pose, scene["gt"], scene["mesh"].vertices)
    print(f"register: {t_reg:.2f}s  ADD-S error {err * 1000:.1f} mm "
          f"(diameter {est.diameter * 1000:.0f} mm, device {device})")
    for f, (gt_f, rgb_f, depth_f) in enumerate(motion_frames(scene, args.frames)):
        t0 = clock()
        pose_f = est.track_one(rgb_f, depth_f, scene["K"])
        dt = clock() - t0
        err_f = metrics.adds_err(pose_f, gt_f, scene["mesh"].vertices)
        print(f"track frame {f}: {dt * 1000:.0f} ms  ADD-S {err_f * 1000:.1f} mm")
    return err


if __name__ == "__main__":
    main()
