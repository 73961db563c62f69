"""Scene-bounds estimation and data normalization for reconstruction.

Counterpart of foundationpose_tpu/field/bounds.py, after the reference's
bundlesdf/tool.py (:17-130: per-frame masked depth clouds, voxel fusion,
outlier rejection, DBSCAN biggest cluster, translation + scale into [-1,1])
and nerf_helpers.preprocess_data (:252-274: BAD_DEPTH sentinel, mask
zeroing, pose normalization). Host numpy + scipy.

The JAX package clusters with sklearn's ``DBSCAN(eps, min_samples=1)``. With
``min_samples=1`` every point is a core point, so its clusters are exactly the
connected components of the graph joining points at most ``eps`` apart;
``biggest_cluster`` finds them with ``cKDTree.query_pairs`` and
``scipy.sparse.csgraph.connected_components`` (sklearn need not be
installed). Clusters are ranked by size, ties going to the cluster whose
first point comes first, which is DBSCAN's label order.
"""

from __future__ import annotations

import logging

import numpy as np

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.core.meshio import voxel_downsample

BAD_DEPTH = 99.0
BAD_COLOR = 0


def frame_cloud(depth, mask, K, pose, downsample=0.01, max_depth=2.0):
    """Masked depth -> world points for one frame. pose: cam_in_ob (4,4)."""
    xyz = geo.depth2xyzmap(depth, K).numpy()
    valid = (np.asarray(mask) > 0) & (depth > 0.001) & (depth < max_depth)
    pts = xyz[valid]
    if len(pts) == 0:
        return np.zeros((0, 3))
    if downsample:
        pts = voxel_downsample(pts, downsample)
    return geo.transform_pts(pts, pose).numpy()


def remove_outliers(pts, k=10, std_ratio=2.0):
    """Statistical outlier removal (replaces open3d's, tool.py:41-62)."""
    if len(pts) < k + 1:
        return pts
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    dists, _ = tree.query(pts, k=k + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return pts[mean_d < thresh]


def cluster_labels(pts, eps):
    """DBSCAN(eps, min_samples=1) labels: connected components of the
    eps-neighbour graph, numbered in the order of each component's first
    point."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    n = len(pts)
    pairs = cKDTree(pts).query_pairs(eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # renumber by first occurrence (DBSCAN visits points in index order)
    _, first = np.unique(comp, return_index=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[comp]


def biggest_cluster(pts, eps=0.06, min_samples=1):
    """DBSCAN biggest cluster (reference tool.py:17-24) for ``min_samples=1``,
    the only setting any caller uses."""
    if min_samples != 1:
        raise ValueError("biggest_cluster implements DBSCAN with min_samples=1 only")
    if len(pts) == 0:
        return pts
    labels = cluster_labels(np.asarray(pts), eps)
    ids, cnts = np.unique(labels, return_counts=True)
    return pts[labels == ids[np.argmax(cnts)]]


def compute_translation_scales(pts, max_dim=2.0, cluster=True, eps=0.06,
                               min_samples=1):
    """Normalization: translation centers the cluster; sc_factor fits it into
    0.9 x [-1,1] (reference tool.py:27-38)."""
    if cluster:
        pts = biggest_cluster(pts, eps=eps, min_samples=min_samples)
    mx = pts.max(axis=0)
    mn = pts.min(axis=0)
    center = (mx + mn) / 2
    sc_factor = max_dim / np.abs(mx - mn).max() * 0.9  # spare 0.1 padding
    translation_cvcam = -center
    return translation_cvcam, sc_factor, pts


def compute_scene_bounds(depths, masks, K, poses, voxel=0.01, eps=0.06,
                         min_samples=1):
    """Fuse all frames -> (translation, sc_factor, fused cluster points)
    (reference tool.py:65-130, frames in series)."""
    clouds = []
    for i in range(len(depths)):
        c = frame_cloud(depths[i], masks[i], K, poses[i], downsample=voxel)
        if len(c):
            clouds.append(c)
    pts = np.concatenate(clouds, axis=0)
    pts = voxel_downsample(pts, voxel)
    pts = remove_outliers(pts)
    translation, sc_factor, cluster_pts = compute_translation_scales(
        pts, eps=eps, min_samples=min_samples
    )
    logging.info("scene bounds: translation=%s sc_factor=%.4f pts=%d",
                 translation, sc_factor, len(cluster_pts))
    return translation, sc_factor, cluster_pts


def preprocess_data(rgbs, depths, masks, poses, sc_factor, translation):
    """Normalize data into the field's [-1,1] frame
    (reference nerf_helpers.py:252-274): invalid/masked depth -> BAD_DEPTH
    sentinel, masked color -> 0, rgb -> [0,1], depth and poses scaled."""
    rgbs = np.asarray(rgbs, dtype=np.float32).copy()
    depths = np.asarray(depths, dtype=np.float32).copy()
    poses = np.asarray(poses, dtype=np.float64).copy()
    depths[depths < 0.001] = BAD_DEPTH
    if masks is not None:
        masks = np.asarray(masks)
        rgbs[masks == 0] = BAD_COLOR
        depths[masks == 0] = BAD_DEPTH
    rgbs = rgbs / 255.0
    depths = depths * sc_factor
    poses[:, :3, 3] += np.asarray(translation)[None]
    poses[:, :3, 3] *= sc_factor
    return rgbs, depths, masks, poses
