"""Neural-object-field reconstruction runner: SDF field training with joint
per-frame pose optimisation, mesh extraction and rendering.

Counterpart of foundationpose_tpu/field/runner.py (``FieldConfig``,
``NeRFRunnerTPU``), after the reference NerfRunner (bundlesdf/nerf_runner.py:
ray building :248-318, train loop + losses :508-692, occupancy-guided
sampling :696-798, compositing :849-886, mesh extraction :1063-1119).

One train step is: draw the ray ids and the sample uniforms from the
runner's ``torch.Generator`` (``draw``), gather the rays, sample, query the
field, every loss term of the config, autograd backward, then two
optimiser updates — the pose array at ``lrate_pose`` and everything else at
``lrate``, each an Adam with eps 1e-15 and its own schedule
``base * decay_rate ** (count / n_step)`` (``models/training.Optimizer``,
optax's arithmetic; the JAX package's ``optax.multi_transform``). The loss
terms stay on the device; the host reads them only at log points.

The per-frame pose array makes training a gradient-based bundle adjustment:
poses and map are optimised jointly, as the reference couples them
(nerf_runner.py:769-771). OpenCV camera convention throughout.

With a ``device_mesh`` (``parallel.mesh.Mesh``, first axis) the step is
data-parallel over the rays, as the JAX package's jitted step is on a sharded
ray batch. Parameters and both optimisers' states are process 0's
(``replicate``); every process builds the rays, the occupancy grid and the
draws of the WHOLE step itself (deterministic host arithmetic, and one
generator seeded alike on every process) and takes its slice of the draws, so
a sharded step sees exactly the draws of an unsharded one. Each mean of the
loss divides the process's sum by the global count (its slice's mean over the
axis size), the eikonal ratio's denominator is summed over the processes
before the backward pass, and the parameter regularisers are added on
process 0 only; so the SUM of the processes' losses is the global loss. The
gradients are then summed over the processes (``all_reduce_grads``) before
both optimisers, and the aux terms for logging. ``n_rand`` must split evenly
(``ValueError`` otherwise).

Checkpoints are ``torch.save`` files under the JAX package's file names. The
JAX package pickles optax state objects, which cannot be unpickled without
optax; the port does not read them.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.field import losses as losses_mod
from foundationpose_tpu_torch.field import sampling
from foundationpose_tpu_torch.field.meshing import extract_sdf_grid_mesh
from foundationpose_tpu_torch.field.nerf import ObjectField
from foundationpose_tpu_torch.models.training import Optimizer


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Defaults = the reference BundleSDF YCB-V config (config_ycbv.yml);
    every field and default of the JAX package's ``FieldConfig``."""

    n_step: int = 1000
    n_rand: int = 2048
    lrate: float = 0.01
    lrate_pose: float = 0.01
    decay_rate: float = 0.1
    n_samples: int = 128
    n_samples_around_depth: int = 128
    # hierarchical importance sampling (reference N_importance,
    # nerf_runner.py:807-830); 0 = off, like the reference default
    n_importance: int = 0
    trunc: float = 0.01  # meters (scaled by sc_factor internally)
    sdf_lambda: float = 5.0
    neg_trunc_ratio: float = 1.0
    fs_sdf: float = 1.0
    near: float = 0.1  # meters
    far: float = 2.0  # meters
    rgb_weight: float = 100.0
    fs_weight: float = 100.0
    empty_weight: float = 1.0
    trunc_weight: float = 6000.0
    feature_reg_weight: float = 0.1
    pose_reg_weight: float = 0.0
    # optional regularizers, 0 by default like the reference
    # (config_ycbv.yml:75,84; nerf_runner.py:559-568)
    fs_rgb_weight: float = 0.0
    eikonal_weight: float = 0.0
    first_frame_weight: float = 1.0
    frame_features: int = 2
    optimize_poses: bool = True
    max_trans: float = 0.02  # meters
    max_rot: float = 10.0  # degrees
    num_levels: int = 16
    log2_hashmap_size: int = 22
    base_res: int = 32
    finest_res: int = 512
    feature_grid_dim: int = 2
    # positional encoder: "triplane" (the JAX package's default) or "hash"
    # (the reference's instant-ngp grid, gridencoder.cu:95-244 semantics)
    encoder: str = "triplane"
    triplane_resolutions: tuple = (16, 32, 64, 128)
    triplane_channels: int = 4
    triplane_freqs: int = 4
    sh_degree: int = 3  # multires_views
    occ_resolution: int = 64
    occ_dilate: int = 2
    mask_dilate_first: int = 50
    mask_dilate: int = 30
    rays_valid_depth_only: bool = True
    mesh_resolution: float = 0.003  # meters
    seed: int = 0
    # periodic artifact hooks (reference i_weights/i_img/i_mesh semantics,
    # nerf_runner.py:594-681): every N steps dump a checkpoint / rendered
    # frame / extracted mesh under ``save_dir``; 0 disables a hook,
    # save_dir=None all three.
    i_weights: int = 0
    i_img: int = 0
    i_mesh: int = 0
    save_dir: str | None = None


def dilate_mask(mask, k):
    """``cv2.dilate(mask, np.ones((k, k)))`` for a 0/1 mask (H,W) tensor: cv2
    anchors a k x k kernel at k // 2, so a set pixel reaches k // 2 pixels
    before it and k - 1 - k // 2 after it (for an even k one fewer after than
    before). A box is separable: one max pool along each axis, each padded
    asymmetrically with zeros."""
    lo, hi = k // 2, k - 1 - k // 2
    m = mask.float()[None, None]
    m = F.max_pool2d(F.pad(m, (lo, hi, 0, 0)), (1, k), stride=1)
    m = F.max_pool2d(F.pad(m, (0, 0, lo, hi)), (k, 1), stride=1)
    return m[0, 0] > 0


def _field_schedule(base, cfg):
    return lambda count: base * cfg.decay_rate ** (count / cfg.n_step)


class NeRFRunner:
    """Train a neural object field from posed RGB-D frames (the port's
    ``NeRFRunnerTPU``).

    Inputs are PRE-normalized (``field.bounds.compute_scene_bounds`` +
    ``preprocess_data``): rgbs (N,H,W,3) in [0,1] with masked pixels zeroed,
    depths (N,H,W) in normalized units (BAD_DEPTH sentinel for invalid),
    masks (N,H,W), poses (N,4,4) cam-in-object normalized (CV convention),
    K (3,3), occ_points (M,3) fused cloud in [-1,1]. ``device=None`` means
    cuda and raises without one. ``device_mesh`` shards the ray batch
    (module docstring).
    """

    def __init__(self, cfg: FieldConfig, rgbs, depths, masks, poses, K, occ_points,
                 sc_factor, translation, device=None, device_mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.device_mesh = device_mesh
        self.world = 1  # processes the ray batch is split over
        if device_mesh is not None:
            if device_mesh.device.type != self.device.type:
                raise ValueError(f"device mesh on {device_mesh.device}, runner on {self.device}")
            self.world = device_mesh.size(device_mesh.axis_names[0])
            if cfg.n_rand % self.world:
                raise ValueError(f"n_rand={cfg.n_rand} does not split evenly over "
                                 f"{self.world} processes")
        self.sc_factor = float(sc_factor)
        self.translation = np.asarray(translation, dtype=np.float64)
        self.K = np.asarray(K, dtype=np.float64)
        self.poses = np.asarray(poses, dtype=np.float32)
        self.H, self.W = depths.shape[1:3]
        self.num_frames = len(rgbs)
        self.global_step = 0
        self.last_aux = {}  # loss-term dict from the last synced train step
        self.log = []  # (step, loss-term dict) read at every log point

        self.occ_grid = torch.as_tensor(
            sampling.build_occupancy_grid(occ_points, resolution=cfg.occ_resolution,
                                          dilate=cfg.occ_dilate),
            device=self.device)
        self.rays = self._build_rays(rgbs, depths, masks)
        logging.info("rays: %s", tuple(self.rays.shape))

        self.field = ObjectField(
            num_frames=self.num_frames,
            frame_features=cfg.frame_features,
            sh_degree=cfg.sh_degree,
            max_trans=cfg.max_trans * self.sc_factor,
            max_rot_deg=cfg.max_rot,
            num_levels=cfg.num_levels,
            level_dim=cfg.feature_grid_dim,
            base_resolution=cfg.base_res,
            desired_resolution=cfg.finest_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            optimize_poses=cfg.optimize_poses,
            encoder=cfg.encoder,
            triplane_resolutions=tuple(cfg.triplane_resolutions),
            triplane_channels=cfg.triplane_channels,
            triplane_freqs=cfg.triplane_freqs,
            seed=cfg.seed,
        ).to(self.device)
        self._make_optimizers()
        if device_mesh is not None:
            from foundationpose_tpu_torch.parallel.mesh import replicate

            self.field.load_state_dict(replicate(device_mesh, dict(self.field.state_dict())))
            for opt in (self.opt, self.opt_pose):
                if opt is not None:
                    opt.load_state_dict(replicate(device_mesh, opt.state_dict()))
        self.c2w = torch.as_tensor(self.poses, device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def _make_optimizers(self):
        """Two groups (nerf_runner create_optimizer :379-391 + schedule_lr
        :425-429): the pose array, and everything else."""
        cfg = self.cfg
        basic = [p for n, p in self.field.named_parameters() if n != "pose_array"]
        self.opt = Optimizer(basic, _field_schedule(cfg.lrate, cfg), eps=1e-15)
        self.opt_pose = (Optimizer([self.field.pose_array], _field_schedule(cfg.lrate_pose, cfg),
                                   eps=1e-15) if cfg.optimize_poses else None)

    # ------------------------------------------------------------------
    def _build_rays(self, rgbs, depths, masks):
        """Per-frame ray tensor: [dir(3) rgb(3) depth(1) mask(1) frame(1)
        type(1)] from mask-dilated pixels (reference make_frame_rays
        :248-318). The dilation runs on the runner's device; the rows are
        assembled on the host, as the JAX package assembles them."""
        cfg = self.cfg
        H, W, K = self.H, self.W, self.K
        us, vs = np.meshgrid(np.arange(W), np.arange(H))
        dirs = np.stack(
            [(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)],
            axis=-1,
        ).astype(np.float32)
        near_n = cfg.near * self.sc_factor
        far_n = cfg.far * self.sc_factor
        all_rays = []
        for i in range(self.num_frames):
            mask = (np.asarray(masks[i]) > 0).astype(np.uint8)
            dil = cfg.mask_dilate_first if i == 0 else cfg.mask_dilate
            if dil > 0:
                mask_d = dilate_mask(torch.as_tensor(mask, device=self.device), dil).cpu().numpy()
            else:
                mask_d = mask > 0
            depth = np.asarray(depths[i])
            invalid_depth = ((depth < near_n) | (depth > far_n)) & (mask > 0)
            ray_type = invalid_depth.astype(np.float32)
            sel = mask_d.copy()
            if cfg.rays_valid_depth_only:
                sel &= ~invalid_depth
            rows = np.concatenate(
                [
                    dirs[sel],
                    np.asarray(rgbs[i])[sel].reshape(-1, 3),
                    depth[sel].reshape(-1, 1),
                    mask[sel].reshape(-1, 1).astype(np.float32),
                    np.full((sel.sum(), 1), i, np.float32),
                    ray_type[sel].reshape(-1, 1),
                ],
                axis=-1,
            )
            all_rays.append(rows.astype(np.float32))
        return torch.as_tensor(np.concatenate(all_rays, axis=0), device=self.device)

    # ------------------------------------------------------------------
    def draw(self):
        """One step's random draws, from the runner's generator on its
        device: ray ids, and the uniforms of the stratified and the depth-band
        samples (and of the importance samples when ``n_importance``). The
        whole step's, also with a device mesh."""
        cfg, g, dev = self.cfg, self.gen, self.device
        n = cfg.n_rand
        d = {
            "ids": torch.randint(0, self.rays.shape[0], (n,), generator=g, device=dev),
            "u_uniform": torch.rand((n, cfg.n_samples), generator=g, device=dev),
            "u_depth": torch.rand((n, cfg.n_samples_around_depth), generator=g, device=dev),
        }
        if cfg.n_importance > 0:
            d["u_imp"] = torch.rand((n, cfg.n_importance), generator=g, device=dev)
        return d

    def loss_fn(self, batch, draws):
        """Loss and the aux dict of loss terms (device tensors) for one ray
        batch (n_rand, 10) and its sample draws; with a device mesh, this
        process's share of them for its slice of the rays (module docstring)."""
        cfg, field, occ, world = self.cfg, self.field, self.occ_grid, self.world
        primary = self.device_mesh is None or self.device_mesh.index(
            self.device_mesh.axis_names[0]) == 0
        trunc = cfg.trunc * self.sc_factor
        near_n = cfg.near * self.sc_factor
        far_n = cfg.far * self.sc_factor

        dirs_cam = batch[:, 0:3]
        target_rgb = batch[:, 3:6]
        target_d = batch[:, 6]
        frame_ids = batch[:, 8].long()
        ray_type = batch[:, 9]

        tf = field.pose_corrections(frame_ids) @ self.c2w[frame_ids]
        rays_o = tf[:, :3, 3]
        dirs_w = torch.einsum("nij,nj->ni", tf[:, :3, :3], dirs_cam)
        viewdirs = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)

        z_vals, valid = sampling.sample_rays(
            draws["u_uniform"], draws["u_depth"], rays_o, dirs_w, target_d, occ, trunc,
            neg_trunc_ratio=cfg.neg_trunc_ratio, far_default=far_n,
            # train losses are per-sample order-free; sample_pdf's bins need
            # ascending z, so sort only when hierarchical sampling is on
            sort=cfg.n_importance > 0,
        )
        pts = rays_o[:, None, :] + dirs_w[:, None, :] * z_vals[..., None]
        valid = valid & (pts.abs() <= 1.0).all(dim=-1)

        raw = field(pts, viewdirs, frame_ids)

        if cfg.n_importance > 0:
            # hierarchical pass (nerf_runner.py:807-830): inverse-CDF resample
            # from the coarse compositing weights (detached), query there too
            w_c = losses_mod.depth_band_weights(
                z_vals, target_d, trunc, cfg.sdf_lambda, far_n, cfg.neg_trunc_ratio) * valid
            z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
            z_imp = sampling.sample_pdf(draws["u_imp"], z_mid, w_c[:, 1:-1]).detach()
            pts_i = rays_o[:, None, :] + dirs_w[:, None, :] * z_imp[..., None]
            valid_i = (sampling.occupancy_lookup(occ, pts_i)
                       & (pts_i.abs() <= 1.0).all(dim=-1)
                       & valid.any(dim=-1, keepdim=True))
            raw_i = field(pts_i, viewdirs, frame_ids)
            z_vals = torch.cat([z_vals, z_imp], dim=-1)
            valid = torch.cat([valid, valid_i], dim=-1)
            raw = torch.cat([raw, raw_i], dim=-2)

        sdf = raw[..., 3]
        valid_rays = valid.any(dim=-1) & (ray_type == 0)
        ray_w = torch.where(frame_ids == 0, cfg.first_frame_weight, 1.0) * valid_rays
        sample_w = ray_w[:, None] * valid

        weights = losses_mod.depth_band_weights(
            z_vals, target_d, trunc, cfg.sdf_lambda, far_n, cfg.neg_trunc_ratio) * valid
        rgb_map = losses_mod.render_rgb(raw, weights)
        # every mean is this slice's mean over the axis size: the global
        # count's share of the slice's sum (exact division by 1 unsharded)
        rgb_loss = cfg.rgb_weight * torch.mean(
            (rgb_map - target_rgb) ** 2 * ray_w[:, None]) / world

        fs, sdf_l, empty, front_m, _ = losses_mod.sdf_losses(
            z_vals, target_d, sdf, trunc, sample_w, near_n, far_n,
            cfg.neg_trunc_ratio, cfg.fs_sdf)
        fs, sdf_l, empty = fs / world, sdf_l / world, empty / world
        loss = rgb_loss + cfg.fs_weight * fs + cfg.trunc_weight * sdf_l + cfg.empty_weight * empty
        if cfg.fs_rgb_weight > 0:
            # free-space colour pushed to white (nerf_runner.py:559-562)
            loss = loss + cfg.fs_rgb_weight * torch.mean(
                ((torch.sigmoid(raw[..., :3]) - 1.0) * front_m[..., None]) ** 2
                * sample_w[..., None]) / world
        if cfg.eikonal_weight > 0:
            # |grad sdf| -> 1 near the surface (nerf_runner.py:564-568): the
            # per-point gradient, kept in the graph so the loss on it is
            # differentiated again (through the triplane's own backward)
            flat = pts.reshape(-1, 3)
            if not flat.requires_grad:
                flat = flat.detach().requires_grad_(True)
            g = torch.autograd.grad(field.sdf(flat).sum(), flat, create_graph=True)[0]
            g = g.reshape(pts.shape)
            near_surf = (sdf < 1.0) & valid
            gnorm = torch.linalg.norm(g, dim=-1)
            n_near = near_surf.sum()
            if self.device_mesh is not None:  # the global count, before the backward pass
                from foundationpose_tpu_torch.parallel.mesh import all_sum

                n_near = all_sum(self.device_mesh, n_near, self.device_mesh.axis_names[0])
            loss = loss + cfg.eikonal_weight * (
                torch.sum((gnorm - 1.0) ** 2 * near_surf) / n_near.clamp_min(1))
        # regularisers on parameters: once over the processes
        if cfg.frame_features > 0 and primary:
            loss = loss + cfg.feature_reg_weight * torch.mean(field.feature_array ** 2)
        if cfg.optimize_poses and cfg.pose_reg_weight > 0 and primary:
            loss = loss + cfg.pose_reg_weight * torch.linalg.norm(field.pose_array[1:])
        aux = {
            "loss": loss,
            "rgb_loss": rgb_loss, "fs_loss": fs, "sdf_loss": sdf_l, "empty_loss": empty,
            "valid_rays": valid_rays.sum(), "valid_samples": valid.sum(),
        }
        return loss, aux

    def grads(self, draws):
        """Loss, aux and the gradient of every parameter for one step's
        draws, without updating anything (what the tests hold against the
        JAX step). With a device mesh: this process's slice of the draws, and
        the global loss, aux and gradients on every process."""
        self.field.zero_grad(set_to_none=True)
        mesh = self.device_mesh
        if mesh is not None:
            from foundationpose_tpu_torch.parallel.mesh import shard_batch

            draws = shard_batch(mesh, draws, mesh.axis_names[0])
        loss, aux = self.loss_fn(self.rays[draws["ids"]], draws)
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if mesh is None:
            return loss.detach(), aux
        from foundationpose_tpu_torch.parallel.mesh import all_reduce_grads, all_sum

        axis = mesh.axis_names[0]
        all_reduce_grads(mesh, self.field.parameters(), axis)
        # one reduce for every aux term, in float64 (exact for the counts)
        summed = all_sum(mesh, torch.stack([v.double() for v in aux.values()]), axis)
        aux = {k: s.to(v.dtype) for (k, v), s in zip(aux.items(), summed)}
        return aux["loss"], aux

    def train_step(self, draws=None):
        """One step: draws (from the generator unless given), loss, backward,
        both optimiser updates. Returns the loss and aux on the device."""
        loss, aux = self.grads(self.draw() if draws is None else draws)
        self.opt.step()
        if self.opt_pose is not None:
            self.opt_pose.step()
        return loss, aux

    # ------------------------------------------------------------------
    def train(self, n_step=None, log_every=100):
        n_step = n_step or self.cfg.n_step
        last_loss = 0.0
        loss = aux = None
        for it in range(n_step):
            loss, aux = self.train_step()
            self.global_step += 1
            if it % log_every == 0:
                # sync point: pull the whole loss-term dict, not just the total
                self.last_aux = {k: float(v) for k, v in aux.items()}
                self.log.append((self.global_step - 1, self.last_aux))
                last_loss = self.last_aux["loss"]
                logging.info("step %d %s", self.global_step - 1,
                             " ".join(f"{k}={v:.4f}" for k, v in self.last_aux.items()))
            self._artifact_hooks()
        if loss is not None:
            last_loss = float(loss)
            self.last_aux = {k: float(v) for k, v in aux.items()}
        return last_loss

    def _artifact_hooks(self):
        """Periodic checkpoint / rendered-frame / mesh dumps (reference
        nerf_runner.py:594-681 i_weights/i_img/i_mesh), gated by config. As in
        the JAX package, a failed image or mesh dump is logged, not raised."""
        cfg = self.cfg
        if not cfg.save_dir:
            return
        step = self.global_step
        if cfg.i_weights and step % cfg.i_weights == 0:
            os.makedirs(os.path.join(cfg.save_dir, "ckpt"), exist_ok=True)
            self.save(os.path.join(cfg.save_dir, "ckpt", "model_latest.npz"))
        if cfg.i_img and step % cfg.i_img == 0:
            os.makedirs(os.path.join(cfg.save_dir, "image_step"), exist_ok=True)
            try:
                from foundationpose_tpu_torch.io import png

                rgb_img, _ = self.render_frame(0, stride=4)
                img = np.clip(np.asarray(rgb_img) * 255, 0, 255).astype(np.uint8)
                png.write_png(os.path.join(cfg.save_dir, "image_step", f"step_{step:07d}.png"),
                              img)
            except Exception as e:  # artifact path must never break training
                logging.warning("i_img dump failed: %s", e)
        if cfg.i_mesh and step % cfg.i_mesh == 0:
            os.makedirs(os.path.join(cfg.save_dir, "mesh_step"), exist_ok=True)
            try:
                from foundationpose_tpu_torch.core import meshio

                meshio.save_obj(
                    os.path.join(cfg.save_dir, "mesh_step", f"step_{step:07d}.obj"),
                    self.extract_mesh())
            except Exception as e:
                logging.warning("i_mesh dump failed: %s", e)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sdf_fn(self, pts):
        """(N,3) normalized points (array or tensor) -> (N,) SDF tensor."""
        return self.field.sdf(torch.as_tensor(np.asarray(pts, np.float32)
                                              if not torch.is_tensor(pts) else pts,
                                              device=self.device))

    def extract_mesh(self, voxel_size=None, isolevel=0.0):
        """Marching tetrahedra over the occupancy-masked SDF grid. Returns a
        Mesh in the NORMALIZED frame (like reference extract_mesh)."""
        voxel = (voxel_size or self.cfg.mesh_resolution) * self.sc_factor

        def valid_fn(pts):
            return sampling.occupancy_lookup(self.occ_grid,
                                             torch.as_tensor(pts, device=self.device))

        return extract_sdf_grid_mesh(
            self.sdf_fn,
            bounds=np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
            voxel_size=voxel,
            iso=isolevel,
            valid_fn=valid_fn,
        )

    def mesh_to_real_world(self, mesh):
        """Normalized-frame mesh -> metric object frame (reference
        mesh_to_real_world, nerf_helpers.py:215-250)."""
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices / self.sc_factor - self.translation[None]
        return mesh

    @torch.no_grad()
    def get_optimized_poses_in_real_world(self):
        """(N,4,4) optimized cam-in-object poses in metric units (CV)."""
        tf = self.field.pose_corrections(
            torch.arange(self.num_frames, device=self.device)).cpu().numpy()
        optimized = tf @ self.poses
        optimized[:, :3, 3] /= self.sc_factor
        optimized[:, :3, 3] -= self.translation[None]
        return optimized

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_frame(self, frame_id, stride=4, chunk=4096):
        """Render rgb + depth for one training frame (debug / eval). The
        stratified samples of every chunk come from a generator seeded 0, as
        the JAX package reuses ``PRNGKey(0)`` per chunk."""
        K, H, W, dev = self.K, self.H, self.W, self.device
        us, vs = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
        dirs = np.stack(
            [(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)],
            axis=-1,
        ).reshape(-1, 3).astype(np.float32)
        n = len(dirs)
        cfg = self.cfg
        trunc = cfg.trunc * self.sc_factor
        far_n = cfg.far * self.sc_factor
        out_rgb, out_depth = [], []
        for s in range(0, n, chunk):
            d = torch.as_tensor(dirs[s:s + chunk], device=dev)
            f = torch.full((d.shape[0],), frame_id, dtype=torch.long, device=dev)
            tf = self.field.pose_corrections(f) @ self.c2w[f]
            rays_o = tf[:, :3, 3]
            dirs_w = torch.einsum("nij,nj->ni", tf[:, :3, :3], d)
            viewdirs = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
            tmin, tmax = sampling.ray_box_intersect(rays_o, dirs_w)
            hit = tmin >= 0
            u = torch.rand((d.shape[0], cfg.n_samples), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
            z = sampling.stratified_samples(
                u, torch.where(hit, tmin, torch.zeros_like(tmin))[:, None],
                torch.where(hit, tmax, torch.full_like(tmax, far_n))[:, None])
            pts = rays_o[:, None, :] + dirs_w[:, None, :] * z[..., None]
            valid = sampling.occupancy_lookup(self.occ_grid, pts) & hit[:, None]
            raw = self.field(pts, viewdirs, f)
            sdf = raw[..., 3]
            # surface from the SDF zero crossing (reference render_images :446-455)
            crossing = (sdf[:, 1:] * sdf[:, :-1] < 0) & valid[:, 1:]
            idx = torch.argmax(crossing.to(torch.uint8), dim=-1)
            zc = torch.gather(z, 1, idx[:, None])[:, 0]
            depth = torch.where(crossing.any(dim=-1), zc, torch.zeros_like(zc))
            w = losses_mod.depth_band_weights(z, depth, trunc, cfg.sdf_lambda, far_n) * valid
            out_rgb.append(losses_mod.render_rgb(raw, w).cpu().numpy())
            out_depth.append(depth.cpu().numpy())
        h, w_ = us.shape
        return (np.concatenate(out_rgb).reshape(h, w_, 3),
                np.concatenate(out_depth).reshape(h, w_))

    # ------------------------------------------------------------------
    def save(self, path):
        """``torch.save`` of the parameters, both optimisers' states, the
        step, the config, the normalisation and the occupancy grid."""
        torch.save({
            "params": {k: v.detach().cpu() for k, v in self.field.state_dict().items()},
            "opt_state": {"basic": self.opt.state_dict(),
                          "pose": self.opt_pose.state_dict() if self.opt_pose else None},
            "global_step": self.global_step,
            "cfg": dataclasses.asdict(self.cfg),
            "sc_factor": self.sc_factor,
            "translation": self.translation.tolist(),
            "occ_grid": self.occ_grid.cpu(),
        }, path)

    def load(self, path):
        data = torch.load(path, map_location=self.device, weights_only=True)
        self.field.load_state_dict(data["params"])
        self._make_optimizers()
        self.opt.load_state_dict(data["opt_state"]["basic"])
        if self.opt_pose is not None:
            self.opt_pose.load_state_dict(data["opt_state"]["pose"])
        self.global_step = data["global_step"]
        if "occ_grid" in data:  # checkpoints written before the grid was saved keep this one
            self.occ_grid = data["occ_grid"].to(self.device)
