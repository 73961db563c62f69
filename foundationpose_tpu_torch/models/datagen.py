"""Synthetic render-and-compare training data.

Counterpart of foundationpose_tpu/models/datagen.py: training pairs made on
the fly with the port's own renderer, on the device of the mesh tensors.

- ground-truth object poses sampled in the camera frustum;
- 'observed' crop B = render at the GT pose, 'hypothesis' crop A = render at
  a perturbed pose, both into the crop window of the PERTURBED pose and
  normalised like the test-time pipeline (``engine/crop.py``);
- targets: the egocentric deltas the refiner must predict, or the ADD
  ranking the scorer must respect.

Every function is split in two: ``draw_*`` makes a small dict of random
tensors from an explicit ``torch.Generator`` (on the card for data made on
the card), and the rest is arithmetic on those draws. ``jax.random`` cannot be
reproduced in torch, so the parity tests feed the JAX package's draws into
the arithmetic. Renders go through ``ops/raster_cuda.render_crops`` — K1s +
K1r on CUDA tensors, the plain rasterizer on CPU tensors — lit, without
normals and unculled, as the JAX package calls ``render_crops_pallas`` here.
Everything runs under ``torch.no_grad()``: renders are data, no gradient
flows through them.
"""

from __future__ import annotations

import logging

import torch

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.ops import raster_cuda


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# poses


def draw_poses(gen, batch, z_range=(0.4, 1.0), xy_frac=0.25):
    return {"w": _normal(gen, (batch, 3)) * 2.0,
            "z": _uniform(gen, (batch, 1), *z_range),
            "xy": _uniform(gen, (batch, 2), -xy_frac, xy_frac)}


def poses_from_draws(d):
    """Random rotations + translations in the frustum."""
    w, z, xy = d["w"], d["z"], d["xy"]
    poses = torch.zeros((w.shape[0], 4, 4), dtype=torch.float32, device=w.device)
    poses[:, 3, 3] = 1.0
    poses[:, :3, :3] = geo.so3_exp_map(w)
    poses[:, :3, 3] = torch.cat([xy * z, z], dim=-1)
    return poses


def draw_perturb(gen, n, trans_scale, rot_scale):
    return {"dt": _uniform(gen, (n, 3), -1.0, 1.0) * trans_scale,
            "dw": _uniform(gen, (n, 3), -1.0, 1.0) * rot_scale}


def perturb_from_draws(poses, d):
    return geo.egocentric_delta_pose_to_pose(poses, d["dt"], geo.so3_exp_map(d["dw"]))


# ---------------------------------------------------------------------------
# domain randomisation of the observed side


def draw_augment(gen, B, S):
    return {
        "bg_col": _uniform(gen, (B, 1, 1, 3)),
        "noise": _normal(gen, (B, S, S, 3)),
        "cell": torch.randint(4, 40, (B, 1, 1), generator=gen, device=gen.device),
        "col2": _uniform(gen, (B, 1, 1, 3)),
        "use_checker": _uniform(gen, (B, 1, 1, 1)) < 0.5,
        "dz": _uniform(gen, (B, S, S, 1), 0.03, 0.5),
        "dxy": _uniform(gen, (B, S, S, 2), -2.0, 2.0),
        # per-pixel coin flips with a per-sample probability
        "bg_on": _uniform(gen, (B, S, S, 1)) < _uniform(gen, (B, 1, 1, 1), 0.3, 1.0),
        "hole": _uniform(gen, (B, S // 8, S // 8)) < _uniform(gen, (B, 1, 1), 0.0, 0.15),
        "occ_box": _uniform(gen, (B, 4)),
        "occ_on": _uniform(gen, (B, 1, 1)) < 0.5,
        "occ_col": _uniform(gen, (B, 1, 1, 3)),
        "occ_dz": _uniform(gen, (B, 1, 1, 1), 0.05, 0.25),
    }


def augment_observed(rgb, xyz, mask, t, radius, d):
    """Domain randomisation of the OBSERVED crop (B side), so training
    matches test conditions where the crop holds background, clutter, sensor
    holes and occluders rather than a black void:

    - background: per-sample base colour + pixel noise for rgb, or (half the
      samples) a random checkerboard; random 3D points near / behind the
      object for xyz;
    - depth holes: coarse 8x8-block dropout of xyz;
    - occluder: a random rectangle IN FRONT of the object (prob 0.5);
    - rgb noise on every pixel — the same normal draw as the background
      noise, as in the JAX package (one key serves both there).

    rgb in [0,1]; xyz camera-space with invalid = 0. Returns (rgb, xyz)."""
    B, S = rgb.shape[0], rgb.shape[1]
    dev = rgb.device
    valid = xyz[..., 2:3] > 0.001

    bg_rgb = (d["bg_col"] + 0.15 * d["noise"]).clamp(0, 1)
    ii = torch.arange(S, device=dev).view(1, S, 1)
    jj = torch.arange(S, device=dev).view(1, 1, S)
    cell = d["cell"]
    board = ((torch.div(ii, cell, rounding_mode="floor")
              + torch.div(jj, cell, rounding_mode="floor")) % 2)[..., None].float()
    checker_rgb = d["bg_col"] * board + d["col2"] * (1.0 - board)
    bg_rgb = torch.where(d["use_checker"], checker_rgb, bg_rgb)
    rgb = torch.where(mask[..., None], rgb, bg_rgb)

    bg_xyz = torch.cat([t[:, None, None, :2] + d["dxy"] * radius,
                        t[:, None, None, 2:] + d["dz"]], dim=-1)
    xyz = torch.where(valid, xyz, torch.where(d["bg_on"], bg_xyz, torch.zeros_like(bg_xyz)))

    hole = d["hole"].repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)[..., None]
    xyz = torch.where(hole, torch.zeros_like(xyz), xyz)

    u0 = d["occ_box"]  # cx, cy, w, h in [0,1]
    fi = torch.arange(S, dtype=torch.float32, device=dev)
    iif = (fi / S).view(1, S, 1)
    jjf = (fi / S).view(1, 1, S)
    half_w = 0.05 + 0.15 * u0[:, 2:3, None]
    half_h = 0.05 + 0.15 * u0[:, 3:4, None]
    inside = ((iif - u0[:, 1:2, None]).abs() < half_h) & ((jjf - u0[:, 0:1, None]).abs() < half_w)
    inside = (inside & d["occ_on"])[..., None]
    occ_z = t[:, None, None, 2:] - d["occ_dz"]
    occ_xyz = torch.cat([t[:, None, None, :2].expand(B, S, S, 2),
                         occ_z.expand(B, S, S, 1)], dim=-1)
    rgb = torch.where(inside, d["occ_col"], rgb)
    xyz = torch.where(inside, occ_xyz, xyz)

    rgb = (rgb + 0.02 * d["noise"]).clamp(0, 1)
    return rgb, xyz


def draw_distractor(gen, B):
    return {"w": _normal(gen, (B, 3)) * 2.0,
            "direction": _normal(gen, (B, 3)),
            "dist": _uniform(gen, (B, 1), 0.7, 1.6),
            "on": _uniform(gen, (B, 1, 1, 1)) < 0.6}


def composite_distractor(render_fn, gt_poses, mesh_diameter, rgbB, xyzB, maskB, d):
    """Render the SAME mesh at a second nearby pose (0.7-1.6 diameters away,
    random rotation) and z-composite it into the observed crops (prob 0.6
    per sample): the hardest clutter negative there is."""
    dR = geo.so3_exp_map(d["w"])
    # flattened along z: (1, 1, 0.35) per axis, without uploading a constant
    direction = torch.cat([d["direction"][:, :2], d["direction"][:, 2:] * 0.35], dim=-1)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True).clamp_min(1e-9)
    dpose = gt_poses.clone()
    dpose[:, :3, :3] = dR
    dpose[:, :3, 3] = dpose[:, :3, 3] + direction * d["dist"] * mesh_diameter
    rD = render_fn(dpose)
    oz = xyzB[..., 2:3]
    dz = rD["xyz"][..., 2:3]
    front = rD["mask"][..., None] & ((oz <= 0.001) | (dz < oz)) & d["on"]
    rgb = torch.where(front, rD["rgb"], rgbB)
    xyz = torch.where(front, rD["xyz"], xyzB)
    return rgb, xyz, maskB | front[..., 0]


# ---------------------------------------------------------------------------
# batches


def _normalize(xyz, t, mesh_diameter, thres, normalize_xyz):
    invalid = xyz[..., 2:3] < thres
    c = xyz - t[:, None, None, :]
    if not normalize_xyz:
        return c
    scaled = c / (mesh_diameter / 2.0)
    bad = invalid | (scaled.abs() >= 2)
    return torch.where(bad, torch.zeros_like(scaled), scaled)


def render_pair(mesh_tensors, K, mesh_diameter, gt, hyp, input_size, crop_ratio,
                z_thres, normalize_xyz=True, aug=None):
    """The arithmetic of a batch: render the hypotheses (A) and the ground
    truth (B) into the hypotheses' crop windows, optionally composite a
    distractor and randomise B (``aug``: {"distractor": ..., "observed": ...}
    draws), normalise xyz with the ``z_thres`` validity threshold."""
    S = int(input_size)
    K = geo.as_f32(K, gt.device)
    tfs = geo.compute_crop_window_tf_batch(hyp, K, crop_ratio, mesh_diameter, (S, S))

    def render(poses):
        return raster_cuda.render_crops(mesh_tensors, poses, K, tfs, out_hw=(S, S),
                                        use_light=True, with_normal=False)

    rA, rB = render(hyp), render(gt)
    t = hyp[:, :3, 3]
    rgbB, xyzB = rB["rgb"], rB["xyz"]
    if aug is not None:
        rgbB, xyzB, maskB = composite_distractor(render, gt, mesh_diameter, rgbB, xyzB,
                                                 rB["mask"], aug["distractor"])
        rgbB, xyzB = augment_observed(rgbB, xyzB, maskB, t, mesh_diameter / 2.0,
                                      aug["observed"])
    A = torch.cat([rA["rgb"], _normalize(rA["xyz"], t, mesh_diameter, z_thres,
                                         normalize_xyz)], dim=-1)
    B = torch.cat([rgbB, _normalize(xyzB, t, mesh_diameter, z_thres, normalize_xyz)], dim=-1)
    return A, B


def _draw_aug(gen, B, S, augment):
    if not augment:
        return None
    return {"distractor": draw_distractor(gen, B), "observed": draw_augment(gen, B, S)}


@torch.no_grad()
def refine_batch_from_poses(mesh_tensors, K, mesh_diameter, gt, hyp, input_size=160,
                            crop_ratio=1.2, normalize_xyz=True, aug=None):
    A, B = render_pair(mesh_tensors, K, mesh_diameter, gt, hyp, input_size, crop_ratio,
                       0.001, normalize_xyz, aug)
    trans_gt, rot_gt = geo.pose_to_egocentric_delta_pose(hyp, gt)
    return {"A": A, "B": B, "trans_gt": trans_gt, "rot_gt": rot_gt,
            "poseA": hyp, "poseB": gt}


@torch.no_grad()
def make_refine_batch(gen, mesh_tensors, K, mesh_diameter, batch=32, input_size=160,
                      crop_ratio=1.2, trans_scale=0.02, rot_scale=0.3490658503988659,
                      normalize_xyz=True, augment=False):
    """Returns dict: A (B,S,S,6) hypothesis crops, B (B,S,S,6) observed crops,
    trans_gt (B,3), rot_gt (B,3,3) — the egocentric deltas A->B — and the
    poses. ``gen`` lives on the mesh tensors' device. ``augment=True``
    randomises the observed side (distractor, background, holes, occluders)."""
    gt = poses_from_draws(draw_poses(gen, batch))
    hyp = perturb_from_draws(gt, draw_perturb(gen, batch, trans_scale, rot_scale))
    aug = _draw_aug(gen, batch, int(input_size), augment)
    return refine_batch_from_poses(mesh_tensors, K, mesh_diameter, gt, hyp, input_size,
                                   crop_ratio, normalize_xyz, aug)


@torch.no_grad()
def score_batch_from_poses(mesh_tensors, K, mesh_diameter, model_pts, gt, hyp,
                           input_size=160, crop_ratio=1.2, normalize_xyz=True, aug=None):
    A, B = render_pair(mesh_tensors, K, mesh_diameter, gt, hyp, input_size, crop_ratio,
                       0.1, normalize_xyz, aug)
    pts_h = geo.transform_pts(model_pts, hyp)
    pts_g = geo.transform_pts(model_pts, gt)
    adds = torch.linalg.norm(pts_h - pts_g, dim=-1).mean(dim=-1)  # ADD per hypothesis
    return {"A": A, "B": B, "adds": adds}


@torch.no_grad()
def make_score_batch(gen, mesh_tensors, K, mesh_diameter, model_pts, n_hyp=16,
                     input_size=160, crop_ratio=1.2, trans_scale=0.04, rot_scale=0.9,
                     normalize_xyz=True, augment=False):
    """One frame with ``n_hyp`` perturbed hypotheses of one GT pose and their
    ADD errors (ranking supervision). ``augment=True`` randomises each crop of
    the observed side on its own, as the JAX package does."""
    gt = poses_from_draws(draw_poses(gen, 1)).expand(n_hyp, 4, 4).contiguous()
    hyp = perturb_from_draws(gt, draw_perturb(gen, n_hyp, trans_scale, rot_scale))
    aug = _draw_aug(gen, n_hyp, int(input_size), augment)
    return score_batch_from_poses(mesh_tensors, K, mesh_diameter, model_pts, gt, hyp,
                                  input_size, crop_ratio, normalize_xyz, aug)


# ---------------------------------------------------------------------------
# per-mesh trainers (the harness's learned-mode fallback)


def _centred(mesh, device):
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.ops import raster

    b = mesh.bounds
    centered = mesh.translated(-(b[0] + b[1]) / 2)
    mt = raster.make_mesh_tensors(centered, device=device)
    return centered, mt, meshio.compute_mesh_diameter(mesh=centered)


def train_scorer_synthetic(mesh, K, steps=200, n_hyp=8, input_size=64, seed=0, lr=1e-3,
                           log_every=50, norm="group", loss_mode="listwise", device=None):
    """Small end-to-end trainer: ScoreNetMultiPair on on-the-fly synthetic
    hypothesis sets ranked by ADD, float32, from a flax-style init drawn
    from ``seed``. Recipe of the JAX package: warmup -> cosine decay with a
    clip at global norm 1, no skipping of non-finite updates. Returns (net,
    losses)."""
    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.models import convert, training
    from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

    device = resolve_device(device)
    centered, mt, diameter = _centred(mesh, device)
    model_pts = geo.as_f32(centered.vertices, device)
    K = geo.as_f32(K, device)
    net = convert.flax_init(ScoreNetMultiPair(c_in=6, norm=norm, residual_attn=True),
                            seed).to(device)
    sched = training.warmup_cosine_decay_schedule(
        0.0, lr, min(300, max(steps // 10, 1)), steps, lr * 0.05)
    opt = training.Optimizer(net.parameters(), sched, clip_norm=1.0)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    losses = []  # device scalars; read at log points and at the end
    for it in range(steps):
        data = make_score_batch(gen, mt, K, diameter, model_pts, n_hyp=n_hyp,
                                input_size=input_size)
        losses.append(training.scorer_train_step(net, opt, data, mode=loss_mode))
        if it % log_every == 0:
            logging.info("scorer train step %d loss %.5f", it, float(losses[-1]))
    return net, torch.stack(losses).tolist()


def train_refiner_synthetic(mesh, K, steps=200, batch=16, input_size=64, seed=0, lr=1e-4,
                            log_every=50, device=None):
    """Small end-to-end trainer: RefineNet on on-the-fly synthetic pairs,
    float32, plain Adam at ``lr`` (the JAX package's
    ``make_refiner_train_state``). Returns (net, losses)."""
    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.models import convert, training
    from foundationpose_tpu_torch.models.refine_net import RefineNet

    device = resolve_device(device)
    _, mt, diameter = _centred(mesh, device)
    K = geo.as_f32(K, device)
    net = convert.flax_init(RefineNet(c_in=6), seed).to(device)
    opt = training.Optimizer(net.parameters(), lr)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    losses = []
    for it in range(steps):
        data = make_refine_batch(gen, mt, K, diameter, batch=batch, input_size=input_size)
        losses.append(training.refiner_train_step(net, opt, data, mesh_diameter=float(diameter)))
        if it % log_every == 0:
            logging.info("refiner train step %d loss %.5f", it, float(losses[-1]))
    return net, torch.stack(losses).tolist()
