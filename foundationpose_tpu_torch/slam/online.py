"""Online model-free tracking and reconstruction (a BundleSDF-style loop).

Counterpart of foundationpose_tpu/slam/online.py:

- frame 0 defines the object frame; a mesh triangulated from its masked depth
  (``depth_map_mesh``) bootstraps render-based tracking;
- ``step`` tracks each frame by the engine's projective point-to-plane ICP
  (``GeometricRefiner``: one K1 render of the single hypothesis with normals
  per iteration) against the current mesh, and adds keyframes that moved far
  enough;
- every ``retrain_every_keyframes`` keyframes (and at ``finalize``) the neural
  field retrains on the keyframes with joint pose refinement, and its
  extracted mesh replaces the tracking model;
- ``run_pose_graph_ba`` refines the keyframe poses by Schur-complement
  Gauss-Newton BA (``slam/ba.py``).

Host state (keyframes, poses) is numpy float64, as in the JAX package; each
frame's tracking runs on ``device`` (None = cuda).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device, upload
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.core.meshio import Mesh, compute_mesh_diameter
from foundationpose_tpu_torch.engine.geometric import GeometricConfig, GeometricRefiner
from foundationpose_tpu_torch.field.runner import FieldConfig
from foundationpose_tpu_torch.ops import raster


def depth_map_mesh(depth, mask, K, stride=2, max_edge=0.02):
    """Triangulate a masked depth map into a surface mesh (the bootstrap
    model): grid-connect neighbouring valid pixels whose depths agree within
    ``max_edge``; vertices are camera-space points (float32)."""
    depth = np.asarray(depth)
    mask = np.asarray(mask) > 0
    xyz = geo.depth2xyzmap(np.asarray(depth, np.float32), K).numpy()
    H, W = depth.shape
    vs = np.arange(0, H, stride)
    us = np.arange(0, W, stride)
    sub_xyz = xyz[np.ix_(vs, us)]  # (h,w,3)
    sub_valid = (mask & (depth > 0.001))[np.ix_(vs, us)]
    h, w = sub_valid.shape
    idx = -np.ones((h, w), np.int64)
    idx[sub_valid] = np.arange(sub_valid.sum())
    verts = sub_xyz[sub_valid]

    z = sub_xyz[..., 2]
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    za, zb, zc, zd = z[:-1, :-1], z[:-1, 1:], z[1:, :-1], z[1:, 1:]
    ok = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0)
    ok &= ((np.abs(za - zb) < max_edge) & (np.abs(za - zc) < max_edge)
           & (np.abs(zd - zb) < max_edge) & (np.abs(zd - zc) < max_edge))
    q = np.stack([a[ok], b[ok], c[ok], d[ok]], axis=-1)
    faces = np.concatenate([q[:, [0, 2, 1]], q[:, [1, 2, 3]]], axis=0)
    return Mesh(verts, faces.astype(np.int32))


@dataclasses.dataclass
class OnlineConfig:
    keyframe_min_rot_deg: float = 10.0
    keyframe_min_trans: float = 0.02
    retrain_every_keyframes: int = 8
    max_keyframes: int = 40
    track_iterations: int = 4
    field: FieldConfig = dataclasses.field(default_factory=lambda: FieldConfig(n_step=300))
    mesh_stride: int = 2
    max_render_faces: int = 8192


class ModelFreeTracker:
    """Track an unknown object from a masked first frame, reconstructing its
    neural field online. ``device=None`` means cuda; every call below runs
    there."""

    def __init__(self, K, config: OnlineConfig | None = None, refiner=None, device=None):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or OnlineConfig()
        self.device = resolve_device(device)
        # a wider ICP inlier gate than registration's: inter-frame motion must
        # stay inside the association band or the solve returns identity
        self.refiner = refiner or GeometricRefiner(GeometricConfig(tau_rel=0.12),
                                                   device=self.device)
        self.keyframes = []  # dicts: rgb, depth, mask, cam_in_ob
        self.cam_in_ob = None  # current camera pose in the object frame
        self.mesh = None
        self.mesh_tensors = None
        self.diameter = None
        self.runner = None
        self.frame_count = 0

    # ------------------------------------------------------------------
    def init(self, rgb, depth, mask):
        """Frame 0: the camera frame is the object frame."""
        self.cam_in_ob = np.eye(4)
        self._set_mesh(depth_map_mesh(depth, mask, self.K, self.cfg.mesh_stride))
        self.keyframes = [dict(rgb=np.asarray(rgb), depth=np.asarray(depth),
                               mask=np.asarray(mask), cam_in_ob=np.eye(4))]
        self.frame_count = 1
        logging.info("online init: bootstrap mesh %d faces, diameter %.3f",
                     len(self.mesh.faces), self.diameter)
        return np.eye(4)

    def _set_mesh(self, mesh):
        """Centre the tracking mesh (the crop window is placed at the
        hypothesis translation, which is the object's centre) and upload it
        unbucketed, decimated to ``max_render_faces``."""
        bounds = mesh.bounds
        self.mesh_center = (bounds[0] + bounds[1]) / 2.0
        centered = mesh.translated(-self.mesh_center)
        self.mesh = mesh  # object frame (uncentred): what callers see
        self.mesh_tensors = raster.make_mesh_tensors(
            centered, max_faces=self.cfg.max_render_faces, device=self.device)
        self.diameter = compute_mesh_diameter(mesh=centered)
        self._to_center = np.eye(4)
        self._to_center[:3, 3] = self.mesh_center
        self._from_center = np.eye(4)
        self._from_center[:3, 3] = -self.mesh_center

    # ------------------------------------------------------------------
    def step(self, rgb, depth, mask=None):
        """Track one frame; maybe add a keyframe; maybe retrain. Returns the
        object-in-camera pose (4,4) float64. (Not under ``no_grad``: a retrain
        inside trains the field.)"""
        if self.cam_in_ob is None:
            raise RuntimeError("call init() first")
        from foundationpose_tpu_torch.engine.estimator import preprocess_depth

        dev = self.device
        K_t = upload(self.K, dev, torch.float32)
        with torch.no_grad():
            _, xyz_map = preprocess_depth(upload(np.asarray(depth, np.float32), dev), K_t)
        ob_in_cam = np.linalg.inv(self.cam_in_ob)
        # refine in the centred-mesh frame, convert back after
        ob_in_cam_c = ob_in_cam @ self._to_center
        refined_c = self.refiner.refine(
            self.mesh_tensors, upload(np.asarray(rgb, np.float32), dev), xyz_map, K_t,
            upload(ob_in_cam_c[None], dev, torch.float32), self.diameter,
            iteration=self.cfg.track_iterations,
        )[0].cpu().numpy().astype(np.float64)
        refined = refined_c @ self._from_center
        self.cam_in_ob = np.linalg.inv(refined)
        self.frame_count += 1

        if mask is not None and self._is_keyframe(self.cam_in_ob):
            self.keyframes.append(dict(rgb=np.asarray(rgb), depth=np.asarray(depth),
                                       mask=np.asarray(mask), cam_in_ob=self.cam_in_ob.copy()))
            logging.info("keyframe %d added (frame %d)", len(self.keyframes), self.frame_count)
            if (len(self.keyframes) % self.cfg.retrain_every_keyframes == 0
                    and len(self.keyframes) >= 4):
                self.retrain()
        return refined

    def _is_keyframe(self, cam_in_ob):
        if len(self.keyframes) >= self.cfg.max_keyframes:
            return False
        for kf in self.keyframes:
            # float32, as the JAX package measures it
            dr = float(geo.rotation_geodesic_distance(cam_in_ob[:3, :3], kf["cam_in_ob"][:3, :3]))
            dt = float(np.linalg.norm(cam_in_ob[:3, 3] - kf["cam_in_ob"][:3, 3]))
            if np.degrees(dr) < self.cfg.keyframe_min_rot_deg and dt < self.cfg.keyframe_min_trans:
                return False
        return True

    def _stacked(self):
        return (np.stack([k["rgb"] for k in self.keyframes]),
                np.stack([k["depth"] for k in self.keyframes]),
                np.stack([k["mask"] for k in self.keyframes]),
                np.stack([k["cam_in_ob"] for k in self.keyframes]))

    def _train_field(self, n_step):
        from foundationpose_tpu_torch.slam.reconstruction import run_neural_object_field

        rgbs, depths, masks, poses = self._stacked()
        cfg = self.cfg.field
        if n_step is not None:
            cfg = dataclasses.replace(cfg, n_step=n_step)
        mesh, optimized, runner = run_neural_object_field(
            cfg, self.K, rgbs, depths, masks, poses, save_dir=None, bake=False,
            device=self.device)
        self.runner = runner
        return mesh, optimized, rgbs, masks, poses

    # ------------------------------------------------------------------
    def retrain(self, n_step=None):
        """(Re)train the neural field on the keyframes (joint pose refinement
        = online BA), refresh the tracking mesh, and carry the keyframe pose
        corrections over to the live pose."""
        mesh, optimized, _, _, poses = self._train_field(n_step)
        if len(mesh.faces) > 50:
            self._set_mesh(mesh)
        for kf, p in zip(self.keyframes, optimized):
            kf["cam_in_ob"] = p
        # keep the live camera pose consistent with the refined map
        self.cam_in_ob = optimized[-1] @ np.linalg.inv(poses[-1]) @ self.cam_in_ob
        logging.info("retrained field on %d keyframes; mesh %d faces",
                     len(self.keyframes), len(self.mesh.faces))

    def run_pose_graph_ba(self, n_landmarks=512, config=None, mesh=None, rounds=3):
        """Second-order keyframe refinement: Schur-complement Gauss-Newton
        pose-graph BA over the keyframe depth maps (``slam/ba.py``). Updates
        the keyframe poses and the live camera pose in place; returns the
        final cost. ``mesh``: a ``parallel.mesh.Mesh`` splitting the
        landmarks."""
        from foundationpose_tpu_torch.slam.ba import pose_graph_ba

        if len(self.keyframes) < 2:
            return 0.0
        _, depths, masks, cams = self._stacked()
        refined, cost = pose_graph_ba(depths, masks, cams, self.K, n_landmarks=n_landmarks,
                                      config=config, mesh=mesh, rounds=rounds,
                                      device=self.device if mesh is None else None)
        for kf, p in zip(self.keyframes, refined):
            kf["cam_in_ob"] = p
        # keep the live pose consistent with the refined last keyframe
        self.cam_in_ob = refined[-1] @ np.linalg.inv(cams[-1]) @ self.cam_in_ob
        logging.info("pose-graph BA over %d keyframes: cost %.3e", len(self.keyframes), cost)
        return cost

    def finalize(self, bake=True, tex_res=1024, n_step=None):
        """Final training pass, then the mesh textured from the keyframes and
        the keyframe poses. Returns (mesh, optimised cam_in_obs)."""
        from foundationpose_tpu_torch.field.texture import bake_texture

        mesh, optimized, rgbs, masks, _ = self._train_field(n_step)
        textured = mesh
        if bake and len(mesh.faces) > 0:
            textured = bake_texture(mesh, rgbs, masks, optimized, self.K, tex_res=tex_res,
                                    device=self.device)
        return textured, optimized
