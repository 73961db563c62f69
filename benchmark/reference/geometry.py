"""Pose and camera geometry (float32 tensors).

OpenCV camera: +x right, +y down, +z forward; ``p_cam = R p_obj + t``;
integer pixel (v, u) is the ray through continuous (u, v).
"""

import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _rodrigues_terms(w):
    theta2 = (w * w).sum(dim=-1)
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2)
    return a, b, c


def so3_exp(w):
    """Axis-angle (..., 3) -> rotation (..., 3, 3) (Rodrigues)."""
    a, b, _ = _rodrigues_terms(w)
    Kx = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(Kx)
    return eye + a[..., None, None] * Kx + b[..., None, None] * (Kx @ Kx)


def se3_exp(xi):
    """(..., 6) [translation, rotation] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _rodrigues_terms(w)
    Kx = hat(w)
    KK = Kx @ Kx
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(Kx)
    T = torch.zeros((*xi.shape[:-1], 4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = eye + a[..., None, None] * Kx + b[..., None, None] * KK
    V = eye + b[..., None, None] * Kx + c[..., None, None] * KK
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def apply_delta(poses, trans_delta, rot_delta):
    """Egocentric update: move the centre by ``trans_delta`` and rotate the
    object about its centre by ``rot_delta``."""
    out = torch.eye(4, dtype=poses.dtype, device=poses.device).repeat(poses.shape[0], 1, 1)
    out[:, :3, 3] = poses[:, :3, 3] + trans_delta
    out[:, :3, :3] = rot_delta @ poses[:, :3, :3]
    return out


def project(pts, K):
    uvw = pts @ K.T
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)


def crop_windows(poses, K, crop_ratio, diameter, size):
    """(B,3,3) original pixel -> crop pixel transforms: a square around the
    projected centre whose half-size is the largest pixel offset of the
    centre moved by +-diameter*crop_ratio/2 along camera x and y, its edges
    rounded half to even."""
    r = float(diameter) * crop_ratio / 2.0
    ex, ey = torch.eye(3, dtype=torch.float32, device=poses.device)[:2] * r
    offsets = torch.stack([torch.zeros_like(ex), ex, -ex, ey, -ey])
    uvs = project(poses[:, None, :3, 3] + offsets[None], K)
    center = uvs[:, 0]
    radius = (uvs - center[:, None]).abs().reshape(poses.shape[0], -1).amax(dim=-1)
    left = torch.round(center[:, 0] - radius)
    right = torch.round(center[:, 0] + radius)
    top = torch.round(center[:, 1] - radius)
    bottom = torch.round(center[:, 1] + radius)
    sx, sy = size / (right - left), size / (bottom - top)
    tf = torch.zeros((poses.shape[0], 3, 3), dtype=torch.float32, device=poses.device)
    tf[:, 0, 0], tf[:, 1, 1] = sx, sy
    tf[:, 0, 2], tf[:, 1, 2] = -left * sx, -top * sy
    tf[:, 2, 2] = 1.0
    return tf


def depth_to_xyz(depth, K):
    """(H,W) depth -> (H,W,3) camera-space points; depth < 1 mm -> 0."""
    H, W = depth.shape
    us = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    vs = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    xyz = torch.stack([(us - K[0, 2]) * depth / K[0, 0],
                       (vs - K[1, 2]) * depth / K[1, 1], depth], dim=-1)
    return torch.where((depth < 0.001)[..., None], torch.zeros_like(xyz), xyz)


def add_gap(pose_a, pose_b, pts):
    """Largest distance a model point (N,3) lands apart under two poses,
    per pose pair: (B,4,4), (B,4,4) -> (B,). float64."""
    a, b, p = pose_a.double(), pose_b.double(), pts.double()
    pa = p @ a[:, :3, :3].transpose(1, 2) + a[:, None, :3, 3]
    pb = p @ b[:, :3, :3].transpose(1, 2) + b[:, None, :3, 3]
    return torch.linalg.norm(pa - pb, dim=-1).amax(dim=-1)
