"""Icosphere construction and camera view sampling (host-side numpy, init-time).

The port's own copy of foundationpose_tpu/core/icosphere.py.

Replaces trimesh.creation.icosphere + the reference's view sampler
(src/Utils.py:483-507): cameras on the unit sphere looking at the origin with
world +z as the up hint.
"""

from __future__ import annotations

import numpy as np


def icosahedron():
    """Unit icosahedron (12 vertices, 20 faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def subdivide(verts, faces):
    """One 4-way loop subdivision step with midpoint dedup."""
    verts = list(map(tuple, verts))
    index = {v: i for i, v in enumerate(verts)}
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key in cache:
            return cache[key]
        m = tuple((np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0)
        if m not in index:
            index[m] = len(verts)
            verts.append(m)
        cache[key] = index[m]
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts, dtype=np.float64), np.asarray(new_faces, dtype=np.int64)


def icosphere(subdivisions=1, radius=1.0):
    """Icosphere mesh: verts projected to the sphere after each subdivision.
    subdivisions=1 -> 42 vertices (the reference's default view count)."""
    verts, faces = icosahedron()
    for _ in range(subdivisions):
        verts, faces = subdivide(verts, faces)
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    return verts * radius, faces


def sample_views_icosphere(n_views=40, subdivisions=None, radius=1.0):
    """Camera-in-object poses on an icosphere, cameras looking at the origin.

    Matches reference Utils.py:483-507: grow subdivisions until >= n_views
    vertices; z-axis points from camera to origin; x = cross(up=[0,0,1], z)
    (with [1,0,0] fallback at the poles); y = cross(z, x).
    Returns (N,4,4) cam_in_ob.
    """
    if subdivisions is not None:
        verts, _ = icosphere(subdivisions, radius)
    else:
        sub = 1
        while True:
            verts, _ = icosphere(sub, radius)
            if verts.shape[0] >= n_views:
                break
            sub += 1
    n = verts.shape[0]
    cam_in_obs = np.tile(np.eye(4)[None], (n, 1, 1))
    cam_in_obs[:, :3, 3] = verts
    z_axis = -verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    x_axis = np.cross(np.tile(up[None], (n, 1)), z_axis)
    degenerate = (np.abs(x_axis) < 1e-12).all(axis=-1)
    x_axis[degenerate] = [1.0, 0.0, 0.0]
    x_axis /= np.linalg.norm(x_axis, axis=-1, keepdims=True)
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis, axis=-1, keepdims=True)
    cam_in_obs[:, :3, 0] = x_axis
    cam_in_obs[:, :3, 1] = y_axis
    cam_in_obs[:, :3, 2] = z_axis
    return cam_in_obs
