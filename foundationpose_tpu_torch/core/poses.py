"""Pose-hypothesis grid construction and pose clustering (host-side numpy).

The port's own copy of foundationpose_tpu/core/poses.py (``euler_matrix_np``,
``symmetry_tfs_from_info``, ``rotation_geodesic_distance_np``,
``cluster_poses``, ``make_rotation_grid``).
``cluster_poses`` runs the greedy pass in the port's host C++ library
(``native/cluster.cpp``, built with g++ at first use); ``cluster_poses_plain``
is the same pass in numpy, the plain version the library is held against.
"""

from __future__ import annotations

import numpy as np

from foundationpose_tpu_torch.core.icosphere import sample_views_icosphere


def euler_matrix_np(ai, aj, ak):
    ci, si = np.cos(ai), np.sin(ai)
    cj, sj = np.cos(aj), np.sin(aj)
    ck, sk = np.cos(ak), np.sin(ak)
    R = np.array(
        [
            [ck * cj, ck * sj * si - sk * ci, ck * sj * ci + sk * si],
            [sk * cj, sk * sj * si + ck * ci, sk * sj * ci - ck * si],
            [-sj, cj * si, cj * ci],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    return T


def symmetry_tfs_from_info(info, rot_angle_discrete=5):
    """BOP models_info.json symmetry entry -> (S,4,4) transforms (discrete
    translations mm -> m; a continuous axis sampled every
    ``rot_angle_discrete`` degrees)."""
    symmetry_tfs = [np.eye(4)]
    if "symmetries_discrete" in info:
        tfs = np.array(info["symmetries_discrete"], dtype=np.float64).reshape(-1, 4, 4)
        tfs[..., :3, 3] *= 0.001
        symmetry_tfs = [np.eye(4)] + list(tfs)
    if "symmetries_continuous" in info:
        axis = np.array(info["symmetries_continuous"][0]["axis"]).reshape(3)
        offset = info["symmetries_continuous"][0]["offset"]
        rxs, rys, rzs = [0.0], [0.0], [0.0]
        angles = np.arange(0, 360, rot_angle_discrete) / 180.0 * np.pi
        if axis[0] > 0:
            rxs = angles
        elif axis[1] > 0:
            rys = angles
        elif axis[2] > 0:
            rzs = angles
        for rx in rxs:
            for ry in rys:
                for rz in rzs:
                    tf = euler_matrix_np(rx, ry, rz)
                    tf[:3, 3] = offset
                    symmetry_tfs.append(tf)
    return np.asarray(symmetry_tfs)


def rotation_geodesic_distance_np(R1, R2):
    tr = np.einsum("...ij,...ij->...", R1, R2)  # tr(R1 @ R2.T)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def _as_pose_arrays(poses, symmetry_tfs):
    poses = np.ascontiguousarray(np.asarray(poses, dtype=np.float64))
    if symmetry_tfs is None:
        symmetry_tfs = np.eye(4)[None]
    return poses, np.ascontiguousarray(np.asarray(symmetry_tfs, dtype=np.float64))


def cluster_poses(angle_diff_deg, dist_diff, poses, symmetry_tfs=None):
    """Greedy pose dedup through the host library: scan poses in order; a
    pose is dropped iff some kept pose is within ``dist_diff`` in translation
    AND within ``angle_diff_deg`` geodesic rotation for at least one symmetry
    transform applied on the right. Returns the kept (M,4,4) poses. Raises
    when the library cannot be built."""
    from foundationpose_tpu_torch.native import cluster_poses_native

    return cluster_poses_native(angle_diff_deg, dist_diff,
                                *_as_pose_arrays(poses, symmetry_tfs))


def cluster_poses_plain(angle_diff_deg, dist_diff, poses, symmetry_tfs=None):
    """``cluster_poses`` in numpy (the plain version)."""
    poses, symmetry_tfs = _as_pose_arrays(poses, symmetry_tfs)

    radian_thres = angle_diff_deg / 180.0 * np.pi
    # all symmetric variants of each rotation: (N,S,3,3)
    Rs = poses[:, :3, :3]
    Ss = symmetry_tfs[:, :3, :3]
    R_sym = np.einsum("nij,sjk->nsik", Rs, Ss)
    ts = poses[:, :3, 3]

    kept: list[int] = [0]
    for i in range(1, len(poses)):
        kt = ts[kept]  # (K,3)
        near = np.linalg.norm(kt - ts[i], axis=-1) < dist_diff
        if not near.any():
            kept.append(i)
            continue
        kept_R = Rs[kept][near]  # (K',3,3)
        d = rotation_geodesic_distance_np(R_sym[i][:, None], kept_R[None])
        if (d < radian_thres).any():
            continue
        kept.append(i)
    return poses[kept]


def make_rotation_grid(min_n_views=40, inplane_step=60, symmetry_tfs=None,
                       cluster_angle_deg=30.0):
    """Icosphere viewpoints x in-plane rotations, clustered
    (40 -> 42 views x 6 in-plane @60deg = 252, clustered at 30deg geodesic
    with the translation gate effectively infinite).
    Returns (M,4,4) object-in-camera rotations (identity translation)."""
    cam_in_obs = sample_views_icosphere(n_views=min_n_views)
    rot_grid = []
    for i in range(len(cam_in_obs)):
        for inplane_rot in np.deg2rad(np.arange(0, 360, inplane_step)):
            cam_in_ob = cam_in_obs[i] @ euler_matrix_np(0, 0, inplane_rot)
            rot_grid.append(np.linalg.inv(cam_in_ob))
    rot_grid = np.asarray(rot_grid)
    return cluster_poses(cluster_angle_deg, 99999.0, rot_grid, symmetry_tfs)
