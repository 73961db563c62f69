"""Pose and camera geometry on torch tensors.

Counterpart of foundationpose_tpu/core/geometry.py, as far as the ported
path needs it: ``normalize``, ``hat``, ``so3_exp_map``, ``se3_exp_map``,
``rotation_6d_to_matrix``, ``euler_matrix``,
``egocentric_delta_pose_to_pose``, ``project_pts``,
``compute_crop_window_tf_batch``, ``depth2xyzmap``.

Conventions
-----------
* Column-vector convention: ``p_cam = T[:3,:3] @ p_obj + T[:3,3]``.
* OpenCV camera: +x right, +y down, +z forward. Integer pixel ``(v, u)`` is
  the camera ray through continuous coordinates ``(u, v)``.
* Functions accept numpy arrays or tensors and return float32 tensors on the
  device of their first tensor argument (numpy input lands on the CPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def as_f32(x, device=None) -> torch.Tensor:
    """numpy / list / tensor -> float32 tensor (on ``device`` when given)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def normalize(v, dim=-1, eps=1e-12):
    v = as_f32(v)
    return v / torch.linalg.norm(v, dim=dim, keepdim=True).clamp_min(eps)


def hat(w):
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    w = as_f32(w)
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_map(log_rot):
    """Rodrigues formula: (..., 3) -> (..., 3, 3), with Taylor branches for
    sin(t)/t and (1-cos t)/t^2 below theta^2 = 1e-8."""
    w = as_f32(log_rot)
    theta2 = (w * w).sum(dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_safe)) / theta2_safe
    )
    Kx = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(Kx)
    return eye + a[..., None, None] * Kx + b[..., None, None] * (Kx @ Kx)


def se3_exp_map(xi):
    """(..., 6) [v, w] (translation part first) -> (..., 4, 4) with the
    standard left-Jacobian V, the same Taylor branches as ``so3_exp_map``."""
    xi = as_f32(xi)
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_safe)) / theta2_safe
    )
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    Kx = hat(w)
    KK = Kx @ Kx
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(Kx)
    R = eye + a[..., None, None] * Kx + b[..., None, None] * KK
    V = eye + b[..., None, None] * Kx + c[..., None, None] * KK
    T = torch.zeros((*xi.shape[:-1], 4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def rotation_6d_to_matrix(d6):
    """Zhou et al. 6D rotation -> (..., 3, 3) with b1/b2/b3 as matrix ROWS
    (the refiner transposes the result before use)."""
    d6 = as_f32(d6)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def euler_matrix(ai, aj, ak):
    """Static-frame xyz Euler angles -> 4x4 ('sxyz'):
    R = Rz(ak) @ Ry(aj) @ Rx(ai). Computed in float32 like its JAX namesake."""
    ai, aj, ak = (as_f32(a) for a in (ai, aj, ak))
    ci, si = torch.cos(ai), torch.sin(ai)
    cj, sj = torch.cos(aj), torch.sin(aj)
    ck, sk = torch.cos(ak), torch.sin(ak)
    R = torch.stack(
        [
            torch.stack([ck * cj, ck * sj * si - sk * ci, ck * sj * ci + sk * si]),
            torch.stack([sk * cj, sk * sj * si + ck * ci, sk * sj * ci - ck * si]),
            torch.stack([-sj, cj * si, cj * ci]),
        ]
    )
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    return T


def egocentric_delta_pose_to_pose(A_in_cam, trans_delta, rot_mat_delta):
    """Refinement update rule: translate the centre, rotate about it."""
    A_in_cam = as_f32(A_in_cam)
    B = torch.eye(4, dtype=A_in_cam.dtype, device=A_in_cam.device).repeat(
        *A_in_cam.shape[:-2], 1, 1
    )
    B[..., :3, 3] = A_in_cam[..., :3, 3] + trans_delta
    B[..., :3, :3] = rot_mat_delta @ A_in_cam[..., :3, :3]
    return B


def project_pts(pts, K):
    """Project cam-space points (..., 3) to pixel coords (..., 2) via K (3,3)."""
    pts = as_f32(pts)
    K = as_f32(K, pts.device)
    uvw = pts @ K.T
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)


def compute_crop_window_tf_batch(poses, K, crop_ratio, mesh_diameter, out_size):
    """Per-hypothesis crop transform ('box_3d' method): a square window around
    the projected object centre with half-size = the max pixel deviation of
    centre +/- (diameter*crop_ratio/2) offsets along camera x/y.
    ``torch.round`` is half-to-even, as ``jnp.round`` is.

    ``poses``: (B,4,4); ``out_size``: (out_w, out_h).
    Returns (B,3,3) mapping original pixel coords -> crop pixel coords.
    """
    poses = as_f32(poses)
    K = as_f32(K, poses.device)
    out_w, out_h = out_size
    r = float(mesh_diameter) * crop_ratio / 2.0
    # centre, +-r along camera x, +-r along camera y; built on the device (an
    # upload of a constant would make every call wait for the stream)
    ex, ey = torch.eye(3, dtype=torch.float32, device=poses.device)[:2] * r
    offsets = torch.stack([torch.zeros_like(ex), ex, -ex, ey, -ey])
    pts = poses[:, None, :3, 3] + offsets[None]  # (B,5,3)
    uvs = project_pts(pts, K)  # (B,5,2)
    center = uvs[:, 0]  # (B,2)
    radius = (uvs - center[:, None, :]).abs().reshape(poses.shape[0], -1).amax(dim=-1)
    left = torch.round(center[:, 0] - radius)
    right = torch.round(center[:, 0] + radius)
    top = torch.round(center[:, 1] - radius)
    bottom = torch.round(center[:, 1] + radius)
    sx = out_w / (right - left)
    sy = out_h / (bottom - top)
    tf = torch.zeros((poses.shape[0], 3, 3), dtype=torch.float32, device=poses.device)
    tf[:, 0, 0] = sx
    tf[:, 1, 1] = sy
    tf[:, 0, 2] = -left * sx
    tf[:, 1, 2] = -top * sy
    tf[:, 2, 2] = 1.0
    return tf


def depth2xyzmap(depth, K, zfar=math.inf):
    """(H,W) depth -> (H,W,3) cam-space xyz; invalid (z<1mm or >zfar) -> 0."""
    depth = as_f32(depth)
    K = as_f32(K, depth.device)
    H, W = depth.shape[-2:]
    us = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    vs = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    xs = (us - K[0, 2]) * depth / K[0, 0]
    ys = (vs - K[1, 2]) * depth / K[1, 1]
    xyz = torch.stack([xs, ys, depth], dim=-1)
    invalid = (depth < 0.001) | (depth > zfar)
    return torch.where(invalid[..., None], torch.zeros_like(xyz), xyz)
