"""Neural-object-field reconstruction entry points.

Counterpart of foundationpose_tpu/slam/reconstruction.py, after the
reference's bundlesdf/run_nerf.py: ``run_neural_object_field`` (:18-46 —
normalise the scene, train the field with joint pose optimisation, extract
and texture the mesh, return the real-world mesh and optimised poses) and the
per-object dataset entry point ``run_one_object`` (:49-102).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.field import bounds as bounds_mod
from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner
from foundationpose_tpu_torch.field.texture import bake_texture


def run_neural_object_field(cfg: FieldConfig, K, rgbs, depths, masks, cam_in_obs,
                            save_dir=None, tex_res=1024, bake=True, device=None):
    """rgbs: (N,H,W,3) uint8/float [0,255]; depths: (N,H,W) meters;
    masks: (N,H,W); cam_in_obs: (N,4,4) OpenCV cam-in-object poses.
    ``device=None`` means cuda.

    Returns (textured_mesh_real_world, optimized_cam_in_obs, runner).
    """
    rgbs = np.asarray(rgbs)
    depths = np.asarray(depths, dtype=np.float32)
    masks = np.asarray(masks)
    cam_in_obs = np.asarray(cam_in_obs, dtype=np.float64)

    translation, sc_factor, cluster = bounds_mod.compute_scene_bounds(
        depths, masks, K, cam_in_obs)
    rgbs_n, depths_n, masks_n, poses_n = bounds_mod.preprocess_data(
        rgbs.astype(np.float32), depths, masks, cam_in_obs, sc_factor, translation)
    occ_pts = (cluster + translation) * sc_factor

    runner = NeRFRunner(cfg, rgbs_n, depths_n, masks_n, poses_n, K, occ_pts, sc_factor,
                        translation, device=device)
    runner.train()

    mesh_n = runner.extract_mesh()
    mesh_real = runner.mesh_to_real_world(mesh_n)
    optimized = runner.get_optimized_poses_in_real_world()

    textured = mesh_real
    if bake and len(mesh_real.faces) > 0:
        textured = bake_texture(mesh_real, rgbs, masks, optimized, K, tex_res=tex_res,
                                device=runner.device)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        meshio.save_obj(os.path.join(save_dir, "mesh_real_world.obj"), textured)
        np.savetxt(os.path.join(save_dir, "optimized_poses.txt"), optimized.reshape(-1, 4))
        runner.save(os.path.join(save_dir, "field_latest.ckpt"))
        logging.info("reconstruction artifacts saved to %s", save_dir)
    return textured, optimized, runner


def run_one_object(reader, ob_id, cfg: FieldConfig, save_dir, n_frames=60, tex_res=1024,
                   device=None):
    """Reconstruct one object from a dataset video using GT poses as the
    initial trajectory (the per-frame pose array refines them) — the
    reference's reference-view setup (run_nerf.run_one_ob :49-74)."""
    ids = np.unique(np.linspace(0, len(reader.color_files) - 1, n_frames).astype(int))
    rgbs, depths, masks, poses = [], [], [], []
    for i in ids:
        mask = reader.get_mask(i, ob_id) if hasattr(reader, "ob_ids") else reader.get_mask(i)
        if mask is None or mask.sum() < 100:
            continue
        rgbs.append(reader.get_color(i))
        depths.append(reader.get_depth(i))
        masks.append(mask)
        if hasattr(reader, "ob_ids"):
            ob_in_cam = reader.get_gt_pose(i, ob_id, mask=mask)
        else:
            ob_in_cam = reader.get_gt_pose(i)
        poses.append(np.linalg.inv(ob_in_cam))  # cam_in_ob
    K = reader.get_K(0) if hasattr(reader, "get_K") else reader.K
    return run_neural_object_field(
        cfg, K, np.stack(rgbs), np.stack(depths), np.stack(masks), np.stack(poses),
        save_dir=save_dir, tex_res=tex_res, device=device)
