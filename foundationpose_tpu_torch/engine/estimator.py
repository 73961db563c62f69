"""FoundationPoseTorch — the pose-engine API: global registration + tracking.

Counterpart of foundationpose_tpu/engine/estimator.py (``EstimatorConfig``,
``FoundationPoseTPU`` -> ``FoundationPoseTorch``): mesh centring and
diameter, icosphere x in-plane rotation-hypothesis grid with symmetric
clustering, translation guess from the mask/depth, iterative
render-and-compare refinement, cross-pose scoring with a top-K polish, and
per-frame multi-hypothesis tracking.

``register`` is the body of the JAX package's ``_register_program`` — the
reference schedule or the funnel (a coarse pass over all hypotheses, optionally
on a decimated mesh and at a smaller crop size, then the remaining iterations
on the top K), plus the final polish; ``track_one`` is ``_track_program_multi``
(and ``_track_program`` for one hypothesis). They run as eager tensor code:
the JAX package's single-dispatch program machinery and integer upload formats
serve a remote-attached accelerator and have no counterpart here. What is kept
of them is the hypothesis-axis bucket: ``register`` pads the rotation grid to a
multiple of 32 with copies of hypothesis 0, because the pads take part in
ScoreNet's cross-pose attention and in the batch-axis neighbourhood of the
geometric score's normals, so scores depend on them. Pads are masked to
``-inf`` after every score and dropped before the result.

With a ``device_mesh`` (``parallel.mesh.Mesh``, first axis) ``register`` runs
on every process of the mesh and splits its work as the JAX package's
sharded program does:

- the full-frame preprocess is row-sharded: each process erodes and filters
  its rows with a 4-row halo (two radius-2 stencils) and the rows are
  gathered, bit for bit the unsharded result;
- the grid is padded to a multiple of ``lcm(32, axis size)`` and each
  process refines its slice of the hypotheses (K1 renders included); the
  refined poses are gathered back in order;
- each process renders and encodes its slice for the scorer: ScoreNet's
  per-pair features are gathered before its attention across all hypotheses,
  and the geometric score takes a one-hypothesis halo on each side of its
  slice (its normals' validity rolls along the hypothesis axis, wrapping at
  the ends of the padded set);

and returns the same ranked list as an unsharded run, up to the rounding of
the nets' kernels at another batch size: with bf16 nets on an H100, a refine
batch of 128 rounds otherwise than one of 256 and five refine iterations
amplify it (scores up to 0.028 apart), while float32 nets agree within
1.2e-7. A batch or frame that does not split evenly over the processes is
processed whole on every one.

Host <-> device traffic goes through two helpers, ``_upload`` (pinned memory,
asynchronous copy) and ``_PoseDownload`` (pinned buffer + an event recorded
after the copy), so that ``track_one(sync=False)`` makes no call that waits
for the card: the pose chain stays on the device between frames and nothing
under ``track_one`` reads a device value on the host. That is not the same as
running frames ahead of a busy card: a frame is a few thousand eager kernel
launches, the CUDA runtime queues only so many before a launch call itself
holds the host, and so the host's lead over the card is a part of a frame.
Queueing whole frames ahead needs the frame as one CUDA graph.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.core import meshio, poses as poses_mod, validate
from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
from foundationpose_tpu_torch.engine.scorer import PoseScorer, ScorerConfig
from foundationpose_tpu_torch.ops import image as imops
from foundationpose_tpu_torch.ops import raster, raster_cuda

HYP_BUCKET = 32  # register pads the hypothesis axis to a multiple of this


def _upload(array, device, dtype=None):
    """numpy array -> tensor on ``device``. On a CUDA device the array is
    staged in pinned memory and copied asynchronously on the current stream
    (the pinned block is recycled only after the copy has run); on the CPU it
    is copied into a new tensor. ``dtype`` converts on the host first."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.clone()  # never an alias of the caller's array
    return t.pin_memory().to(device, non_blocking=True)


class _PoseDownload:
    """A device tensor on its way to the host: an asynchronous copy into a
    pinned buffer and an event recorded behind it. ``ready()`` never waits;
    ``numpy()`` waits for the event. On the CPU there is nothing to wait for."""

    def __init__(self, tensor):
        if tensor.is_cuda:
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = tensor, None

    def ready(self):
        return self._event is None or self._event.query()

    def numpy(self):
        if self._event is not None and not self._event.query():
            self._event.synchronize()
        return self._host.numpy().astype(np.float64)


PREPROCESS_HALO = 4  # rows: erode (radius 2), then bilateral (radius 2)


def preprocess_depth(depth, K, mesh=None):
    """erode + bilateral + xyz map (the per-frame depth preprocessing). With
    a device ``mesh`` whose first axis divides the rows, each process filters
    its rows with a ``PREPROCESS_HALO`` halo and the rows are gathered: the
    stencils are local, so the result is the unsharded one bit for bit."""
    axis = mesh.axis_names[0] if mesh is not None else None
    if mesh is None or mesh.size(axis) == 1 or depth.shape[0] % mesh.size(axis):
        d = imops.bilateral_filter_depth(imops.erode_depth(depth, radius=2), radius=2)
        return d, geo.depth2xyzmap(d, K)
    from foundationpose_tpu_torch.parallel.mesh import all_gather_rows, shard_rows

    rows, (lo, hi) = shard_rows(mesh, depth, PREPROCESS_HALO, axis)
    d = imops.bilateral_filter_depth(imops.erode_depth(rows, radius=2), radius=2)
    d = all_gather_rows(mesh, d[lo:d.shape[0] - hi], axis)
    return d, geo.depth2xyzmap(d, K)


def guess_translation(depth, mask, K):
    """Translation guess: mask bbox centre ray x median masked depth, with
    ``np.median`` semantics (mean of the two middle elements for even
    counts). Returns (center (3,) tensor, n_valid int)."""
    m = mask > 0
    valid = m & (depth >= 0.001)
    n_valid = int(valid.sum())
    if n_valid == 0 or not bool(m.any()):
        return torch.zeros(3, device=depth.device), n_valid
    vs, us = torch.nonzero(m, as_tuple=True)
    uc = (us.min().float() + us.max().float()) / 2.0
    vc = (vs.min().float() + vs.max().float()) / 2.0
    s = torch.sort(depth[valid]).values
    zc = (s[(n_valid - 1) // 2] + s[n_valid // 2]) / 2.0
    ray = torch.stack([uc, vc, torch.ones_like(uc)])
    return torch.linalg.inv(K) @ ray * zc, n_valid


@dataclasses.dataclass
class EstimatorConfig:
    min_n_views: int = 40
    inplane_step: int = 60
    cluster_angle_deg: float = 30.0
    register_iterations: int = 5
    track_iterations: int = 2
    # multi-hypothesis tracking: per frame, refine 1 + 7 slightly perturbed
    # copies of the chain pose and keep the scorer's argmax. 1 restores the
    # reference's refine-only track_one.
    track_hypotheses: int = 8
    # perturbation fan magnitudes (x mesh diameter / degrees)
    track_perturb_trans_rel: float = 0.015
    track_perturb_rot_deg: float = 1.5
    # track-time observed gating: zero observed rgb/depth beyond this
    # dilation radius (crop pixels) around each candidate's RENDERED
    # silhouette. 0 disables.
    track_gate_px: int = 12
    # host pre-crop: process only a fixed SxS window around the last pose
    # instead of the full frame. 0 disables.
    track_crop_size: int = 224
    track_crop_margin: float = 1.4
    max_render_faces: int = 4096  # decimation bound for the render mesh
    # register-time observed gating: zero observed rgb/depth beyond this
    # dilation radius (pixels) around the segmentation mask. 0 restores
    # reference behaviour.
    register_mask_dilation: int = 10
    # hierarchical polish: re-refine the top-K scored hypotheses for extra
    # iterations, then re-score. 0 restores the exact reference schedule.
    final_refine_iterations: int = 2
    final_refine_top_k: int = 8
    # funnel schedule: refine ALL hypotheses for ``funnel_coarse_iterations``,
    # score, then run the remaining iterations only on the top
    # ``funnel_top_k``. 0 disables (every hypothesis gets every iteration).
    funnel_top_k: int = 0
    funnel_coarse_iterations: int = 1
    # crop size of the coarse pass (the fine pass and every score that ranks
    # the result stay at the full input size). 0 = full size.
    funnel_coarse_size: int = 0
    # face budget of the coarse pass: it renders a vertex-clustering-decimated
    # copy of the mesh. 0 = the full render mesh.
    funnel_coarse_faces: int = 0
    # debug artifact dumps (PNG, into debug_dir): 1 = posed box + axes of the
    # registered pose, 2 = + render | observed canvas of the top hypotheses,
    # 3 = + one canvas per refine iteration of their replayed refinement
    debug: int = 0
    debug_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "foundationpose_debug"))
    refiner: RefinerConfig = dataclasses.field(default_factory=RefinerConfig)
    scorer: ScorerConfig = dataclasses.field(default_factory=ScorerConfig)


class FoundationPoseTorch:
    """Register/track API. Usage:

    >>> est = FoundationPoseTorch(mesh, refiner=refiner, scorer=scorer)
    >>> pose = est.register(K, rgb, depth, ob_mask)   # (4,4) original frame
    >>> pose = est.track_one(rgb, depth, K)

    ``device=None`` means cuda (raises without one); ``device="cpu"`` runs
    the plain rasterizer and float32 nets on the CPU. ``device_mesh``: a
    ``parallel.mesh.Mesh`` whose first axis shards ``register``'s work
    (every process of it calls ``register``; see the module docstring).
    """

    def __init__(self, mesh: meshio.Mesh, symmetry_tfs=None,
                 config: EstimatorConfig | None = None,
                 refiner: PoseRefiner | None = None, scorer=None,
                 device=None, device_mesh=None):
        self.cfg = config or EstimatorConfig()
        self.device = resolve_device(device)
        if device_mesh is not None and device_mesh.device.type != self.device.type:
            raise ValueError(f"device mesh on {device_mesh.device}, estimator on {self.device}")
        self.device_mesh = device_mesh
        self.refiner = refiner or PoseRefiner(self.cfg.refiner, device=self.device)
        self.scorer = scorer or PoseScorer(self.cfg.scorer, device=self.device)
        for name, part in (("refiner", self.refiner), ("scorer", self.scorer)):
            if part.device.type != self.device.type:
                raise ValueError(f"{name} lives on {part.device}, estimator on {self.device}")
        self.reset_object(mesh, symmetry_tfs)
        self.pose_last = None
        self.scores = None
        self.poses = None

    @property
    def pose_last(self):
        """Last pose of the centred mesh, (4,4) float64. While tracking, the
        chain lives on the device; reading this waits for it."""
        if self._pose_last_dev is not None and self._pose_last_np is None:
            self._pose_last_np = _PoseDownload(self._pose_last_dev).numpy()[0]
        return self._pose_last_np

    @pose_last.setter
    def pose_last(self, value):
        self._pose_last_np = None if value is None else np.asarray(value, np.float64)
        self._pose_last_dev = None  # (1,4,4) float32 tracking chain on the device
        self._pose_hint = self._pose_last_np  # host copy that places the pre-crop window
        self._pending = None  # _PoseDownload of [chain pose, user pose] in flight

    def _enable_backface_cull(self):
        self.refiner.cfg = dataclasses.replace(self.refiner.cfg, backface_cull=True)
        self.scorer.cfg = dataclasses.replace(self.scorer.cfg, backface_cull=True)

    # ------------------------------------------------------------------
    def reset_object(self, mesh: meshio.Mesh, symmetry_tfs=None):
        """Centre the mesh, compute the diameter, build mesh tensors and the
        rotation grid."""
        bounds = mesh.bounds
        self.model_center = (bounds[0] + bounds[1]) / 2.0
        self.mesh_ori = mesh
        centered = mesh.translated(-self.model_center)
        self.mesh = centered
        self.diameter = meshio.compute_mesh_diameter(mesh=centered)
        if symmetry_tfs is None:
            symmetry_tfs = np.eye(4)[None]
        self.symmetry_tfs = np.asarray(symmetry_tfs, dtype=np.float64)
        self.mesh_tensors = raster.make_mesh_tensors(
            centered, max_faces=self.cfg.max_render_faces, bucket=True,
            device=self.device,
        )
        # optional LOD for the funnel's coarse pass
        if self.cfg.funnel_coarse_faces > 0:
            self.mesh_tensors_coarse = raster.make_mesh_tensors(
                centered, max_faces=self.cfg.funnel_coarse_faces, bucket=True,
                device=self.device,
            )
        else:
            self.mesh_tensors_coarse = self.mesh_tensors
        self._tf_centered_dev = _upload(
            self.get_tf_to_centered_mesh(), self.device, torch.float32)
        self.rot_grid = poses_mod.make_rotation_grid(
            min_n_views=self.cfg.min_n_views,
            inplane_step=self.cfg.inplane_step,
            symmetry_tfs=self.symmetry_tfs,
            cluster_angle_deg=self.cfg.cluster_angle_deg,
        ).astype(np.float32)
        # backface culling is exact for closed CCW meshes and halves the
        # rasterizer's face work; enable it automatically when safe
        self.watertight = meshio.is_watertight(centered)
        if self.watertight:
            self._enable_backface_cull()
        self._track_perturb_cache = None
        logging.info(
            "reset_object: diameter=%.4f rot_grid=%s render_faces=%d",
            self.diameter, self.rot_grid.shape, self.mesh_tensors["faces"].shape[0],
        )

    def get_tf_to_centered_mesh(self):
        tf = np.eye(4, dtype=np.float64)
        tf[:3, 3] = -self.model_center
        return tf

    def _track_perturb(self):
        """Deterministic (K-1, 6) [dt camera-frame | axis-angle] perturbation
        fan for multi-hypothesis tracking: camera-plane translations and
        in-plane (camera-z) rotations, scaled to the mesh diameter."""
        k = self.cfg.track_hypotheses
        cache_key = (k, float(self.diameter))
        if self._track_perturb_cache is not None and self._track_perturb_cache[0] == cache_key:
            return self._track_perturb_cache[1]
        dt = self.cfg.track_perturb_trans_rel * self.diameter
        dr = np.radians(self.cfg.track_perturb_rot_deg)
        base = np.array([
            [+dt, 0, 0, 0, 0, 0],
            [-dt, 0, 0, 0, 0, 0],
            [0, +dt, 0, 0, 0, 0],
            [0, -dt, 0, 0, 0, 0],
            [0, 0, 0, 0, 0, +dr],
            [0, 0, 0, 0, 0, -dr],
            [+dt * 0.7071, +dt * 0.7071, 0, 0, 0, 0],
        ], np.float32)
        if k - 1 <= len(base):
            fan = base[: k - 1]
        else:
            # extend deterministically with random small 6-dof deltas
            rng = np.random.default_rng(0)
            extra = rng.uniform(-1.0, 1.0, (k - 1 - len(base), 6)).astype(np.float32)
            extra[:, :3] *= dt
            extra[:, 3:] *= dr
            fan = np.concatenate([base, extra])
        fan_t = _upload(fan, self.device)
        self._track_perturb_cache = (cache_key, fan_t)
        return fan_t

    @staticmethod
    def _as_u8(img):
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a
        return np.clip(a, 0, 255).astype(np.uint8)

    def _hyp_quantum(self):
        """The hypothesis axis is padded to a multiple of this."""
        if self.device_mesh is None:
            return HYP_BUCKET
        return math.lcm(HYP_BUCKET, self.device_mesh.size(self.device_mesh.axis_names[0]))

    def _split_mesh(self, n):
        """The device mesh when a batch of ``n`` splits evenly over its first
        axis (of more than one process), else None: such a batch is processed
        whole on every process."""
        mesh = self.device_mesh
        if mesh is None:
            return None
        size = mesh.size(mesh.axis_names[0])
        return mesh if size > 1 and n % size == 0 else None

    def _refine(self, mt, obs, poses, diam, iterations, **kw):
        """``refiner.refine`` over a hypothesis batch. With a device mesh each
        process refines its slice and the slices are gathered back in order."""
        mesh = self._split_mesh(poses.shape[0])
        if mesh is None:
            return self.refiner.refine(mt, *obs, poses, diam, iterations, **kw)
        from foundationpose_tpu_torch.parallel.mesh import all_gather_rows, shard_batch

        axis = mesh.axis_names[0]
        mine = self.refiner.refine(mt, *obs, shard_batch(mesh, poses, axis), diam, iterations,
                                   **kw)
        return all_gather_rows(mesh, mine, axis)

    def _score(self, mt, obs, poses, diam, **kw):
        """``scorer.score`` over a hypothesis batch; with a device mesh each
        process scores its slice (``device_mesh=`` of the scorers)."""
        mesh = self._split_mesh(poses.shape[0])
        if mesh is None:
            return self.scorer.score(mt, *obs, poses, diam, **kw)
        return self.scorer.score(mt, *obs, poses, diam, device_mesh=mesh, **kw)

    def _top_k(self, scores, k):
        # stable descending order: ties go to the lower index
        return torch.argsort(-scores, stable=True)[:k]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def register(self, K, rgb, depth, ob_mask, iteration=None):
        """Global registration. Returns (4,4) float64 pose of the ORIGINAL
        (uncentred) mesh in camera."""
        iteration = int(iteration or self.cfg.register_iterations)
        K = np.asarray(validate.check_intrinsics(K), dtype=np.float64)
        rgb, depth = validate.check_rgbd(rgb, depth, name="register")
        ob_mask = validate.check_mask(ob_mask, depth.shape, name="register")
        cfg, dev = self.cfg, self.device

        K_t = _upload(K, dev, torch.float32)
        rgb_t = _upload(self._as_u8(rgb), dev).float()
        depth_t = _upload(np.asarray(depth, np.float32), dev)
        mask_t = _upload(np.asarray(ob_mask) > 0, dev)
        if cfg.register_mask_dilation:
            # gate the OBSERVED frame to a dilated margin around the
            # segmentation mask; zeroed depth reads as sensor holes
            gate = imops.dilate_mask(mask_t, radius=int(cfg.register_mask_dilation))
            depth_t = torch.where(gate, depth_t, torch.zeros_like(depth_t))
            rgb_t = rgb_t * gate[..., None]
        d, xyz_map = preprocess_depth(depth_t, K_t, self.device_mesh)
        center, n_valid = guess_translation(d, mask_t, K_t)
        if n_valid < 4:
            logging.info("valid pixel count < 4; returning translation-only pose")
            pose = np.eye(4)
            pose[:3, 3] = center.cpu().numpy()
            return pose

        # pad the hypothesis axis to its bucket (and to a multiple of the
        # device mesh's axis) with copies of hypothesis 0;
        # a pad would score like the real entry it copies, so every score is
        # masked to -inf on the pads, which sends them to the tail of the sort
        # (and keeps them out of the funnel's and the polish's top K)
        n_orig = len(self.rot_grid)
        grid = self.rot_grid[np.r_[0:n_orig, np.zeros((-n_orig) % self._hyp_quantum(), int)]]
        n_hyp = len(grid)
        hyp = _upload(grid, dev)
        hyp[:, :3, 3] = center[None]
        is_pad = torch.arange(n_hyp, device=dev) >= n_orig
        mt, diam = self.mesh_tensors, float(self.diameter)
        obs = (rgb_t, xyz_map, K_t)

        def rescore_top(refined, scores, k, iterations):
            """Refine the ``k`` best for ``iterations`` more on the full mesh
            at full size, rescore them and lift them above the field (+100);
            a rescored entry never resurrects a pad's -inf."""
            top_i = self._top_k(scores, min(k, n_hyp))
            top = self._refine(mt, obs, refined[top_i], diam, iterations)
            top_s = self._score(mt, obs, top, diam)
            refined, scores = refined.clone(), scores.clone()
            refined[top_i] = top
            scores[top_i] = top_s + 100.0
            return refined, scores.masked_fill(is_pad, -torch.inf)

        n_coarse = min(cfg.funnel_coarse_iterations, iteration - 1)
        if 0 < cfg.funnel_top_k < n_hyp and iteration > n_coarse > 0:
            # coarse pass over ALL hypotheses, optionally on the LOD mesh and
            # at a smaller crop size: its scores only select the top K
            mtc, size = self.mesh_tensors_coarse, cfg.funnel_coarse_size or None
            refined = self._refine(mtc, obs, hyp, diam, n_coarse, out_size=size)
            scores = self._score(mtc, obs, refined, diam, out_size=size)
            scores = scores.masked_fill(is_pad, -torch.inf)
            refined, scores = rescore_top(
                refined, scores, cfg.funnel_top_k, iteration - n_coarse)
        else:
            refined = self._refine(mt, obs, hyp, diam, iteration)
            scores = self._score(mt, obs, refined, diam)
            scores = scores.masked_fill(is_pad, -torch.inf)
        if cfg.final_refine_iterations > 0:
            refined, scores = rescore_top(
                refined, scores, cfg.final_refine_top_k, cfg.final_refine_iterations)
        order = torch.argsort(-scores, stable=True)[:n_orig]  # pads are the tail
        self.poses = refined[order].cpu().numpy().astype(np.float64)
        self.scores = scores[order].cpu().numpy()
        self.hyp_order = order.cpu().numpy()  # ranked slot -> rotation-grid index
        self._last_center = center.cpu().numpy()
        self._last_iteration = iteration
        self.pose_last = self.poses[0]
        best = self.poses[0] @ self.get_tf_to_centered_mesh()
        if cfg.debug >= 1:
            self._dump_register_debug(K, rgb, depth, best)
        return best

    # ------------------------------------------------------------------
    def _render_observe_strip(self, K, rgb, poses, size=160):
        """[render | observed] comparison canvas for a set of (centred-mesh)
        poses: the rendered crops (K1s + K1r on the card) beside the observed
        frame warped into the same windows."""
        from foundationpose_tpu_torch.utils import vis as vis_mod

        dev = self.device
        poses_t = _upload(np.asarray(poses), dev, torch.float32)
        K_t = _upload(K, dev, torch.float32)
        tfs = geo.compute_crop_window_tf_batch(
            poses_t, K_t, self.refiner.cfg.crop_ratio, float(self.diameter), (size, size))
        out = raster_cuda.render_crops(
            self.mesh_tensors, poses_t, K_t, tfs, out_hw=(size, size),
            backface_cull=self.refiner.cfg.backface_cull, with_normal=False)
        observed = imops.warp_crop_affine(
            _upload(np.asarray(rgb), dev, torch.float32), tfs, (size, size)) / 255.0
        return vis_mod.make_comparison_strip(out["rgb"].cpu().numpy(),
                                             observed.cpu().numpy())

    def _dump_register_debug(self, K, rgb, depth, best_pose):
        """Debug artifacts by level (reference estimater.py:176-221,
        predict_score.py:27-52): level >= 1 saves the posed box / axis
        overlay; >= 2 adds a render | observed canvas of the top-scoring
        hypotheses; >= 3 replays the top hypotheses' refinement from their
        grid rotations and dumps one canvas per iteration
        (predict_pose_refine.py:241-293)."""
        from foundationpose_tpu_torch.utils import vis as vis_mod

        out_dir = self.cfg.debug_dir
        os.makedirs(out_dir, exist_ok=True)
        img = vis_mod.draw_posed_3d_box(K, self._as_u8(rgb), best_pose, self.mesh_ori.bounds)
        img = vis_mod.draw_xyz_axis(img, best_pose, scale=float(self.diameter) / 2, K=K)
        self._imwrite(os.path.join(out_dir, "vis_register.png"), img)
        k = min(5, len(self.poses))
        if self.cfg.debug >= 2:
            canvas = self._render_observe_strip(K, rgb, self.poses[:k])
            self._imwrite(os.path.join(out_dir, "vis_score_top.png"), canvas)
        if self.cfg.debug >= 3:
            dev = self.device
            K_t = _upload(K, dev, torch.float32)
            rgb_t = _upload(np.asarray(rgb), dev, torch.float32)
            _, xyz_map = preprocess_depth(_upload(np.asarray(depth, np.float32), dev), K_t)
            hyp = self.rot_grid[self.hyp_order[:k]].copy()
            hyp[:, :3, 3] = self._last_center[None]
            poses_it = _upload(hyp, dev, torch.float32)
            for it in range(self._last_iteration):
                poses_it = self.refiner.refine(self.mesh_tensors, rgb_t, xyz_map, K_t,
                                               poses_it, float(self.diameter), 1)
                canvas = self._render_observe_strip(K, rgb, poses_it.cpu().numpy())
                self._imwrite(os.path.join(out_dir, f"vis_refine_iter_{it:02d}.png"), canvas)

    @staticmethod
    def _imwrite(path, img):
        from foundationpose_tpu_torch.io import png

        try:
            png.write_png(path, np.asarray(img).astype(np.uint8))
        except (OSError, ValueError) as e:  # debug-only path: never break registration
            logging.warning("debug imwrite failed: %s", e)

    # ------------------------------------------------------------------
    def _crop_pose_hint(self):
        """Freshest pose available on the HOST without waiting for the card:
        the last pose read back, refreshed from the download in flight once it
        has landed. It only PLACES the pre-crop window — a frame or two of
        staleness is covered by ``track_crop_margin``; the pose chain itself
        always continues from the exact pose on the device."""
        if self._pending is not None and self._pending.ready():
            self._pose_hint = self._pending.numpy()[0]
            self._pending = None
        if self._pose_hint is None:
            self._pose_hint = self.pose_last  # waits (first call after a device-only chain)
        return self._pose_hint

    def _pretrack_crop(self, rgb_u8, depth, K):
        """Fixed-size host crop around the last tracked pose. Returns
        (rgb, depth, K') with the principal point shifted (camera-frame
        geometry is unchanged by an image crop). Falls back to the full frame
        when the object would not fit at the configured window size."""
        S = self.cfg.track_crop_size
        H, W = depth.shape
        if not S or (H <= S and W <= S):
            return rgb_u8, depth, K
        t = self._crop_pose_hint()[:3, 3]
        z = max(float(t[2]), 1e-3)
        f = max(K[0, 0], K[1, 1])
        r = self.diameter * self.cfg.refiner.crop_ratio / 2.0
        side = 2.0 * r * f / z * self.cfg.track_crop_margin
        if side > S:
            return rgb_u8, depth, K  # object too big for the window
        u = K[0, 0] * t[0] / z + K[0, 2]
        v = K[1, 1] * t[1] / z + K[1, 2]
        u0 = int(np.clip(round(u - S / 2), 0, max(W - S, 0)))
        v0 = int(np.clip(round(v - S / 2), 0, max(H - S, 0)))
        rgb_c = np.ascontiguousarray(rgb_u8[v0 : v0 + S, u0 : u0 + S])
        depth_c = np.ascontiguousarray(depth[v0 : v0 + S, u0 : u0 + S])
        K2 = K.copy()
        K2[0, 2] -= u0
        K2[1, 2] -= v0
        return rgb_c, depth_c, K2

    @torch.no_grad()
    def track_one(self, rgb, depth, K, iteration=None, sync=True):
        """Track from the last pose: refine the chain pose and its
        perturbation fan, score, keep the argmax (the unperturbed chain wins
        ties through a +0.01 bonus). With ``track_hypotheses=1`` it is
        refine-only and — as in the JAX package — ungated. Returns the (4,4)
        float64 pose of the ORIGINAL mesh in camera.

        ``sync=False`` streams: the frame's work is enqueued on the current
        CUDA stream and a (4,4) float32 tensor on the device is returned at
        once (the same pose; converting it, or reading ``pose_last``, waits).
        The chain pose never leaves the device and no call below reads a
        device value or synchronises, so the next frame can be prepared and
        enqueued while this one runs. The host's lead is bounded all the same:
        a frame is a few thousand launches, and once the CUDA runtime's launch
        queue is full a launch call holds the host until the card has caught
        up (see the module docstring). On the CPU the tensor is simply
        returned. Both modes give the same poses."""
        if self._pose_last_dev is None and self._pose_last_np is None:
            raise RuntimeError("call register() before track_one()")
        iteration = int(iteration or self.cfg.track_iterations)
        K = np.asarray(validate.check_intrinsics(K), dtype=np.float64)
        rgb, depth = validate.check_rgbd(rgb, depth, name="track_one")
        rgb_u8 = self._as_u8(rgb)
        depth = np.asarray(depth, np.float32)
        rgb_u8, depth, K = self._pretrack_crop(rgb_u8, depth, K)
        # The JAX package sends tracking depth as 16-bit steps of 0.25 mm
        # (dynamic scale beyond 16.4 m); the same rounding is applied here so
        # both packages filter the same depth values.
        dmax = float(depth.max()) if depth.size else 0.0
        scale = 0.00025 if dmax <= 0.00025 * 65535.0 else dmax / 65535.0
        depth_q = (np.clip(depth, 0.0, None) * (1.0 / scale) + 0.5).astype(np.uint16)
        depth = depth_q.astype(np.float32) * np.float32(scale)

        # nothing below reads a device value on the host
        dev = self.device
        K_t = _upload(K, dev, torch.float32)
        rgb_t = _upload(rgb_u8, dev).float()
        _, xyz_map = preprocess_depth(_upload(depth, dev), K_t)
        pose_last = self._pose_last_dev
        if pose_last is None:
            pose_last = _upload(self._pose_last_np[None], dev, torch.float32)
        mt, diam = self.mesh_tensors, float(self.diameter)
        if self.cfg.track_hypotheses > 1:
            gate = int(self.cfg.track_gate_px)
            perturb = self._track_perturb()
            base = pose_last.expand(perturb.shape[0], 4, 4)
            dR = geo.so3_exp_map(perturb[:, 3:])
            hyp = torch.cat(
                [pose_last, geo.egocentric_delta_pose_to_pose(base, perturb[:, :3], dR)]
            )
            refined = self.refiner.refine(
                mt, rgb_t, xyz_map, K_t, hyp, diam, iteration, gate_px=gate
            )
            scores = self.scorer.score(
                mt, rgb_t, xyz_map, K_t, refined, diam, gate_px=gate
            ).clone()
            scores[0] += 0.01  # stickiness: the unperturbed chain wins ties
            # index_select: indexing with a 0-d device tensor would read it on the host
            best = refined.index_select(0, torch.argmax(scores).reshape(1))
        else:
            best = self.refiner.refine(
                mt, rgb_t, xyz_map, K_t, pose_last, diam, iteration
            )
        out = best[0] @ self._tf_centered_dev
        self._pose_last_dev = best
        self._pose_last_np = None
        landing = _PoseDownload(torch.stack([best[0], out]))
        if not sync:
            # the pre-crop hint and any later read of pose_last pick the
            # download up once it has landed
            self._pending = landing
            return out
        arr = landing.numpy()
        self._pose_last_np = self._pose_hint = arr[0]
        self._pending = None
        return arr[1]
