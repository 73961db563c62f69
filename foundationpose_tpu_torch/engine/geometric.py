"""Geometric hypothesis score (what ``HybridScorer`` needs).

Counterpart of foundationpose_tpu/engine/geometric.py: ``GeometricConfig``,
``_geo_score`` with ``_normals_from_xyz``, ``_edge_map`` and ``_dilate``.
``torch.roll`` wraps around at the crop border exactly as ``jnp.roll`` does.
The projective-ICP refiner and the ``GeometricRefiner``/``GeometricScorer``
wrappers of that module are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.engine.crop import make_crop_batch


@dataclasses.dataclass(frozen=True)
class GeometricConfig:
    crop_ratio: float = 1.2
    input_size: int = 160
    tau_rel: float = 0.05  # inlier threshold as a fraction of mesh diameter
    tau0_rel: float = 0.3  # coarse ICP threshold (unused by the score)
    # normal agreement breaks flipped-face ties, edge alignment breaks
    # tangential-slide ties
    w_normal: float = 0.3
    w_edge: float = 0.3
    # drop camera-facing-away triangles (exact for closed CCW meshes)
    backface_cull: bool = False


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
