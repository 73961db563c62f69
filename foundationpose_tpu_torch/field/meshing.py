"""Isosurface extraction from a dense SDF grid (host-side numpy).

The port's own copy of foundationpose_tpu/field/meshing.py: on the same SDF
grid it gives the same mesh, bit for bit. Only ``extract_sdf_grid_mesh``
differs: ``sdf_fn`` and ``valid_fn`` may return tensors (the runner queries
the SDF on its device in chunks of 2^18 points).

Replaces the reference's skimage marching-cubes call
(nerf_runner.extract_mesh :1100-1107) with a self-contained vectorized
marching-tetrahedra implementation: each cube is split into 6 tetrahedra
around its main diagonal; every tetrahedron contributes 0-2 triangles with
vertices linearly interpolated on its edges. No case tables beyond the 16
tetrahedron configurations; only sign-mixed cubes are processed.
"""

from __future__ import annotations

import numpy as np

from foundationpose_tpu_torch.core.meshio import Mesh

# cube corners: bit code x | y<<1 | z<<2
_CORNERS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.int64
)[[0, 1, 2, 3, 4, 5, 6, 7]]
# 6 tetrahedra around the 0-7 diagonal; hexagonal edge walk 3-1-5-4-6-2-3
_TETS = np.array(
    [[0, 7, 3, 1], [0, 7, 1, 5], [0, 7, 5, 4], [0, 7, 4, 6], [0, 7, 6, 2], [0, 7, 2, 3]],
    dtype=np.int64,
)
# tetrahedron edges by local corner pairs
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)
# case -> list of triangles, each triangle = 3 edge indices. Bit i set <=>
# corner i is inside (value < iso).
_CASES: dict[int, list[tuple[int, int, int]]] = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 4, 3)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 5, 4)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1001: [(0, 1, 5), (0, 5, 4)],
    0b0110: [(0, 1, 5), (0, 5, 4)],
    0b1010: [(0, 3, 5), (0, 5, 2)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0111: [(2, 5, 4)],
    0b1011: [(1, 5, 3)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 2, 1)],
}


def marching_tetrahedra(sdf, iso=0.0, origin=(0.0, 0.0, 0.0), spacing=1.0):
    """sdf: (Nx,Ny,Nz) scalar field. Returns a Mesh in world coords
    (origin + index*spacing). Vertices are deduplicated."""
    sdf = np.asarray(sdf, dtype=np.float64)
    Nx, Ny, Nz = sdf.shape
    inside = sdf < iso
    # cubes with mixed signs only
    m = np.zeros((Nx - 1, Ny - 1, Nz - 1), dtype=np.int64)
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        m += inside[dx : Nx - 1 + dx, dy : Ny - 1 + dy, dz : Nz - 1 + dz]
    cx, cy, cz = np.nonzero((m > 0) & (m < 8))
    if len(cx) == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int32))

    base = np.stack([cx, cy, cz], axis=-1)  # (C,3)
    # per-cube corner values and positions
    corner_idx = base[:, None, :] + _CORNERS[None]  # (C,8,3)
    vals = sdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # (C,8)
    pos = corner_idx.astype(np.float64)  # grid coords

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # (C,4)
        tp = pos[:, tet]  # (C,4,3)
        case = ((tv < iso) * np.array([1, 2, 4, 8])).sum(axis=-1)  # (C,)
        for case_id, case_tris in _CASES.items():
            sel = np.nonzero(case == case_id)[0]
            if len(sel) == 0:
                continue
            v = tv[sel]  # (S,4)
            p = tp[sel]  # (S,4,3)
            # interpolated point on each of the 6 tet edges
            ea, eb = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
            va, vb = v[:, ea], v[:, eb]  # (S,6)
            denom = np.where(np.abs(vb - va) < 1e-12, 1.0, vb - va)
            t = np.clip((iso - va) / denom, 0.0, 1.0)  # (S,6)
            ep = p[:, ea] + t[..., None] * (p[:, eb] - p[:, ea])  # (S,6,3)
            for (e0, e1, e2) in case_tris:
                tris.append(np.stack([ep[:, e0], ep[:, e1], ep[:, e2]], axis=1))

    tri_pts = np.concatenate(tris, axis=0)  # (T,3,3) in grid coords
    # drop degenerate triangles
    a = tri_pts[:, 1] - tri_pts[:, 0]
    b = tri_pts[:, 2] - tri_pts[:, 0]
    normal = np.cross(a, b)
    area2 = np.linalg.norm(normal, axis=-1)
    keep = area2 > 1e-12
    tri_pts, normal = tri_pts[keep], normal[keep]

    # consistent winding: normals must point along +grad(sdf) (outward)
    gx, gy, gz = np.gradient(sdf)
    cen = tri_pts.mean(axis=1)
    ci = np.clip(np.round(cen).astype(np.int64), 0, np.array(sdf.shape) - 1)
    g = np.stack(
        [gx[ci[:, 0], ci[:, 1], ci[:, 2]],
         gy[ci[:, 0], ci[:, 1], ci[:, 2]],
         gz[ci[:, 0], ci[:, 1], ci[:, 2]]], axis=-1,
    )
    flip = (normal * g).sum(axis=-1) < 0
    tri_pts[flip] = tri_pts[flip][:, ::-1]

    # dedup vertices by quantization
    flat = tri_pts.reshape(-1, 3)
    keys = np.round(flat * 1e6).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_index=False, return_inverse=True)
    # representative positions
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)

    spacing = np.broadcast_to(np.asarray(spacing, dtype=np.float64), (3,))
    world = verts * spacing[None] + np.asarray(origin, dtype=np.float64)[None]
    return Mesh(world, faces)


def _host(x):
    """A tensor (on any device) or array -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def extract_sdf_grid_mesh(sdf_fn, bounds, voxel_size, iso=0.0, chunk=2**18,
                          valid_fn=None):
    """Query ``sdf_fn`` on a dense grid over ``bounds`` ((2,3) min/max) at
    ``voxel_size`` and run marching tetrahedra. ``valid_fn`` (optional) masks
    query points (occupancy); invalid points get +1 (outside), matching the
    reference's octree-validity fill (nerf_runner.py:1096-1097)."""
    bounds = np.asarray(bounds, dtype=np.float64)
    axes = [
        np.arange(bounds[0, k] + 0.5 * voxel_size, bounds[1, k], voxel_size)
        for k in range(3)
    ]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    shape = grid.shape[:3]
    flat = grid.reshape(-1, 3).astype(np.float32)
    out = np.ones(len(flat), dtype=np.float32)
    if valid_fn is not None:
        valid = _host(valid_fn(flat))
    else:
        valid = np.ones(len(flat), dtype=bool)
    idx = np.nonzero(valid)[0]
    for s in range(0, len(idx), chunk):
        sel = idx[s : s + chunk]
        out[sel] = _host(sdf_fn(flat[sel])).reshape(-1)
    sdf = out.reshape(shape)
    origin = np.array([axes[0][0], axes[1][0], axes[2][0]])
    return marching_tetrahedra(sdf, iso=iso, origin=origin, spacing=voxel_size)
