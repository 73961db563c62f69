"""Geometry-only refinement and scoring (no learned weights required).

Counterpart of foundationpose_tpu/engine/geometric.py:

- :class:`GeometricRefiner` — projective ICP (``_icp_refine``): per crop pixel
  the rendered hypothesis xyz is associated with the observed xyz, an adaptive
  per-hypothesis inlier threshold weighs the pairs, and one damped
  point-to-plane + point-to-point step (``_point_to_plane_delta``) updates
  each pose. ``_kabsch_delta`` is the closed-form weighted rigid fit (Horn's
  quaternion method) of that module.
- :class:`GeometricScorer` — ``_geo_score``: depth consistency + normal
  agreement + silhouette edges, also the veto half of ``HybridScorer``.

Both classes have the interface of ``PoseRefiner`` / ``PoseScorer`` and drop
into ``FoundationPoseTorch``. The JAX package maps one solve over the
hypotheses with ``vmap``; here every function takes leading batch axes and the
normal equations are formed as batched products, never per pixel.
``torch.roll`` wraps around at the crop border exactly as ``jnp.roll`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.engine.crop import make_crop_batch


@dataclasses.dataclass(frozen=True)
class GeometricConfig:
    crop_ratio: float = 1.2
    input_size: int = 160
    tau_rel: float = 0.05  # inlier threshold as a fraction of mesh diameter
    # upper end of the ICP's adaptive inlier threshold, as a fraction of the
    # diameter: it must cover the translation guess's bias (the guess sits on
    # the visible front surface, ~D/4 in front of a convex object's centre)
    tau0_rel: float = 0.3
    # normal agreement breaks flipped-face ties, edge alignment breaks
    # tangential-slide ties
    w_normal: float = 0.3
    w_edge: float = 0.3
    # drop camera-facing-away triangles (exact for closed CCW meshes)
    backface_cull: bool = False


def _eye4_like(x, batch_shape):
    return torch.eye(4, dtype=x.dtype, device=x.device).expand(*batch_shape, 4, 4)


def _kabsch_delta(src, dst, w):
    """Weighted rigid transform D minimising sum w |D src - dst|^2.

    src/dst: (..., P, 3); w: (..., P). Returns (..., 4, 4). Horn's quaternion
    method: the eigenvector of the largest eigenvalue of the 4x4 correlation
    matrix (``q`` and ``-q`` give the same rotation). Identity where the
    weights sum to 10 or less."""
    src, dst, w = geo.as_f32(src), geo.as_f32(dst), geo.as_f32(w)
    wsum = w.sum(dim=-1).clamp_min(1e-6)
    cs = (w[..., None] * src).sum(dim=-2) / wsum[..., None]
    cd = (w[..., None] * dst).sum(dim=-2) / wsum[..., None]
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    H = (w[..., None] * s).transpose(-1, -2) @ d  # sum w s d^T, (..., 3, 3)
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
    ], dim=-2)
    q = torch.linalg.eigh(N).eigenvectors[..., -1]  # (w,x,y,z), ascending eigenvalues
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)], dim=-1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)], dim=-1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)], dim=-1),
    ], dim=-2)
    T = torch.zeros((*wsum.shape, 4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = cd - (R @ cs[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    ok = (wsum > 10.0)[..., None, None]
    return torch.where(ok, T, _eye4_like(T, wsum.shape))


def _point_to_plane_delta(p, q, n, w, mu=0.2, damping=1e-6):
    """One linearised ICP step: D = exp([t, theta]) minimising

        sum w (n.(p + theta x p + t - q))^2  +  mu sum w |p + theta x p + t - q|^2

    The point-to-point term (mu) removes the tangential null space that pure
    point-to-plane has on flat surfaces (boxes). p/q/n: (..., P, 3); w:
    (..., P). Returns (..., 4, 4); identity where the weights sum to 10 or
    less.

    The 6x6 normal equations are batched products over the point axis. The
    point-to-point block, whose Jacobian is [-[p]x | I] per point, is summed
    in closed form — sum w (|p|^2 I - p p^T), [sum w p]x, (sum w) I — so no
    per-point 3x6 or 6x6 array is ever formed."""
    p, q, n, w = geo.as_f32(p), geo.as_f32(q), geo.as_f32(n), geo.as_f32(w)
    batch = w.shape[:-1]
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    # point-to-plane block
    r3 = p - q
    r = (n * r3).sum(dim=-1)                                  # (..., P)
    J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)  # (..., P, 6): [theta, t]
    wJt = (w[..., None] * J).transpose(-1, -2)                # (..., 6, P)
    A = wJt @ J
    b = -(wJt @ r[..., None])[..., 0]
    # point-to-point block
    wp = w[..., None] * p
    M = wp.transpose(-1, -2) @ p                              # sum w p p^T
    sw = w.sum(dim=-1)
    swp_x = geo.hat(wp.sum(dim=-2))
    A3 = torch.zeros((*batch, 6, 6), dtype=p.dtype, device=p.device)
    A3[..., :3, :3] = (M.diagonal(dim1=-2, dim2=-1).sum(dim=-1))[..., None, None] * eye3 - M
    A3[..., :3, 3:] = swp_x
    A3[..., 3:, :3] = -swp_x
    A3[..., 3:, 3:] = sw[..., None, None] * eye3
    wr3 = w[..., None] * r3
    b3 = torch.cat([torch.linalg.cross(p, wr3, dim=-1).sum(dim=-2), wr3.sum(dim=-2)], dim=-1)
    A = A + mu * A3
    b = b - mu * b3

    eye6 = torch.eye(6, dtype=p.dtype, device=p.device)
    trace = A.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    A = A + (damping * trace / 6.0)[..., None, None] * eye6 + 1e-9 * eye6
    # solve_ex: no check of the factorisation's status, which would make the
    # host wait for the card once per call
    x = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
    T = geo.se3_exp_map(torch.cat([x[..., 3:], x[..., :3]], dim=-1))
    ok = (sw > 10.0)[..., None, None]
    return torch.where(ok, T, _eye4_like(T, batch))


@torch.no_grad()
def _icp_refine(cfg, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                iteration, gate_px=0):
    """Projective point-to-plane ICP over the hypothesis batch with an
    adaptive per-hypothesis inlier threshold (trimmed-ICP style): tau is twice
    the mean association error, kept inside [tau_rel/2, tau0_rel] x diameter,
    so a register seed a quarter-diameter off still captures inliers while a
    tracking correction of a millimetre associates tightly from the first
    iteration. Every iteration renders the batch with normals."""
    poses = geo.as_f32(poses, mesh_tensors["pos"].device)
    tau0 = cfg.tau0_rel * mesh_diameter
    tau1 = 0.5 * cfg.tau_rel * mesh_diameter
    for _ in range(int(iteration)):
        data = make_crop_batch(
            mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
            crop_ratio=cfg.crop_ratio, out_size=cfg.input_size,
            normalize_xyz=False, z_invalid_thres=0.001, use_normal=True,
            backface_cull=cfg.backface_cull, gate_px=int(gate_px),
        )
        # un-centre the crop xyz maps (normalize_xyz=False still subtracts t)
        t = poses[:, :3, 3][:, None, None, :]
        xyzA = data["inputA"][..., 3:] + t  # rendered, camera space
        xyzB = data["inputB"][..., 3:] + t  # observed, camera space
        validA = data["mask"][..., None] & (xyzA[..., 2:3] > 0.001)
        valid = (validA & data["validB"]).float()  # the exactly-warped validity
        err = torch.linalg.norm(xyzA - xyzB, dim=-1, keepdim=True)
        # outliers beyond tau0 (background, occluders) cannot inflate the mean
        n_valid = valid.sum(dim=(1, 2, 3)).clamp_min(1.0)
        e_mean = (valid * err.clamp_max(tau0)).sum(dim=(1, 2, 3)) / n_valid
        tau = (2.0 * e_mean).clamp(tau1, tau0)[:, None, None, None]
        w = (valid * (err < tau).float())[..., 0]
        B = poses.shape[0]
        deltas = _point_to_plane_delta(
            xyzA.reshape(B, -1, 3), xyzB.reshape(B, -1, 3),
            data["normalA"].reshape(B, -1, 3), w.reshape(B, -1),
        )
        poses = deltas @ poses
    return poses


class GeometricRefiner:
    """Projective-ICP refiner with the ``PoseRefiner`` interface. ``out_size``
    (the funnel's coarse-resolution hint) is accepted and ignored, as in the
    JAX package: the ICP always runs at ``cfg.input_size``."""

    def __init__(self, config: GeometricConfig = GeometricConfig(), device=None):
        self.cfg = config
        self.device = resolve_device(device)

    def refine(self, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
               iteration=5, out_size=None, gate_px=0):
        """poses: (N,4,4) -> refined (N,4,4) float32 tensor on the device."""
        return _icp_refine(self.cfg, mesh_tensors, poses, K, rgb, xyz_map,
                           mesh_diameter, int(iteration), gate_px=gate_px)


class GeometricScorer:
    """Depth-consistency scorer with the ``PoseScorer`` interface
    (``out_size`` accepted and ignored)."""

    def __init__(self, config: GeometricConfig = GeometricConfig(), device=None):
        self.cfg = config
        self.device = resolve_device(device)

    def score(self, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
              out_size=None, gate_px=0, device_mesh=None):
        """poses: (N,4,4) -> scores (N,) float32 tensor on the device
        (``device_mesh``: see ``geo_score``)."""
        return geo_score(self.cfg, mesh_tensors, poses, K, rgb, xyz_map,
                         mesh_diameter, gate_px=gate_px, device_mesh=device_mesh)


def geo_score(cfg, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter, gate_px=0,
              device_mesh=None):
    """``_geo_score`` of every hypothesis. With a ``device_mesh`` (first axis;
    N splits evenly over it) each process scores its slice and the scores are
    gathered in order. A hypothesis's score reads its neighbours on the
    hypothesis axis (``_normals_from_xyz`` rolls the observed validity along
    it, wrapping round), so each slice is scored with one hypothesis of halo
    on either side, wrapped at the ends of the whole set, and the halo's
    scores are dropped."""
    if device_mesh is None:
        return _geo_score(cfg, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                          gate_px=gate_px)
    from foundationpose_tpu_torch.parallel.mesh import all_gather_rows, shard_rows

    axis = device_mesh.axis_names[0]
    mine, (lo, hi) = shard_rows(device_mesh, poses, 1, axis, wrap=True)
    s = _geo_score(cfg, mesh_tensors, mine, K, rgb, xyz_map, mesh_diameter, gate_px=gate_px)
    return all_gather_rows(device_mesh, s[lo:s.shape[0] - hi], axis)


def _normals_from_xyz(xyz, valid):
    """Per-pixel surface normals of an organized xyz map by central
    differences + cross product. Returns (..., H, W, 3) unit normals and a
    validity mask (all four neighbours valid). Orientation: flipped to face
    the camera (n_z < 0), matching rendered normals of visible surfaces."""
    dx = torch.roll(xyz, -1, dims=-2) - torch.roll(xyz, 1, dims=-2)  # d/du
    dy = torch.roll(xyz, -1, dims=-3) - torch.roll(xyz, 1, dims=-3)  # d/dv
    # Mirrored as the JAX function has it: it rolls ``valid`` (one axis fewer
    # than ``xyz``) with the axis numbers of ``xyz``, so the "du" neighbours
    # are taken along the rows and the "dv" neighbours along the BATCH axis.
    # Kept for parity of the scores; see ROADMAP.md queue 3.
    vx = torch.roll(valid, -1, dims=-2) & torch.roll(valid, 1, dims=-2)
    vy = torch.roll(valid, -1, dims=-3) & torch.roll(valid, 1, dims=-3)
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    return n, valid & vx & vy


def _edge_map(mask):
    """Boolean boundary map of a (..., H, W) mask (4-neighbour erosion)."""
    interior = (
        mask
        & torch.roll(mask, 1, dims=-1) & torch.roll(mask, -1, dims=-1)
        & torch.roll(mask, 1, dims=-2) & torch.roll(mask, -1, dims=-2)
    )
    return mask & ~interior


def _dilate(mask, r=1):
    """(..., H, W) boolean dilation by a (2r+1) box."""
    out = mask
    for ax in (-1, -2):
        for s in range(1, r + 1):
            out = out | torch.roll(out, s, dims=ax) | torch.roll(out, -s, dims=ax)
    return out


@torch.no_grad()
def _geo_score(cfg, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter, gate_px=0):
    """Depth-consistency + normal-agreement + silhouette-edge score, (N,).

    - depth: inliers minus violations (observed surface clearly in front of
      the render) minus half the silhouette misses, over rendered pixels;
    - normal agreement: mean cosine between rendered normals and
      central-difference normals of the observed xyz crop, over depth inliers;
    - edge alignment: fraction of rendered-silhouette-boundary pixels within
      1 px of an observed depth-discontinuity or validity edge.
    """
    tau = cfg.tau_rel * mesh_diameter * 0.5
    data = make_crop_batch(
        mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
        crop_ratio=cfg.crop_ratio, out_size=cfg.input_size,
        normalize_xyz=False, z_invalid_thres=0.001, use_normal=True,
        backface_cull=cfg.backface_cull, gate_px=int(gate_px),
    )
    poses = geo.as_f32(poses, data["inputA"].device)
    t = poses[:, :3, 3][:, None, None, :]
    xyzB = data["inputB"][..., 3:] + t
    zA = data["inputA"][..., 5] + t[..., 2]
    zB = xyzB[..., 2]
    validA = data["mask"] & (zA > 0.001)
    validB = data["validB"][..., 0]  # exactly-warped validity (see crop.py)
    both = validA & validB
    inlier = both & ((zA - zB).abs() < tau)
    violation = both & (zB < zA - tau)
    silhouette_miss = validA & ~validB

    def count(m):
        return m.sum(dim=(1, 2)).float()

    nA = count(validA).clamp_min(1)
    depth_score = (count(inlier) - count(violation) - 0.5 * count(silhouette_miss)) / nA

    nB, nB_valid = _normals_from_xyz(xyzB, validB)
    cosine = (data["normalA"] * nB).sum(dim=-1)
    n_ok = inlier & nB_valid
    cos_mean = (cosine * n_ok).sum(dim=(1, 2)) / count(n_ok).clamp_min(1)

    edgeA = _edge_map(validA)
    zB_safe = torch.where(validB, zB, torch.zeros_like(zB))
    jump = torch.zeros_like(validB)
    for ax, s in ((-1, 1), (-1, -1), (-2, 1), (-2, -1)):
        nb_z = torch.roll(zB_safe, s, dims=ax)
        nb_v = torch.roll(validB, s, dims=ax)
        jump = jump | (nb_v & ((zB_safe - nb_z).abs() > tau)) | ~nb_v
    edgeB = _dilate(validB & jump, r=1)
    edge_hit = count(edgeA & edgeB) / count(edgeA).clamp_min(1)

    return depth_score + cfg.w_normal * cos_mean + cfg.w_edge * edge_hit
