"""Pose-accuracy metrics: ADD and ADD-S (host-side numpy).

Counterpart of foundationpose_tpu/core/metrics.py (``add_err``,
``adds_err``). ADD-S uses a KD-tree nearest neighbour; the JAX package's
chunked brute force computes the same minimum.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _transform(pts, pose):
    pts = np.asarray(pts, np.float64)
    pose = np.asarray(pose, np.float64)
    return pts @ pose[:3, :3].T + pose[:3, 3]


def add_err(pred, gt, model_pts):
    """Mean L2 between corresponding transformed model points."""
    d = _transform(model_pts, pred) - _transform(model_pts, gt)
    return float(np.linalg.norm(d, axis=-1).mean())


def adds_err(pred, gt, model_pts):
    """Mean nearest-neighbour distance from GT-transformed points to
    pred-transformed points (symmetric-object metric)."""
    tree = cKDTree(_transform(model_pts, pred))
    dist, _ = tree.query(_transform(model_pts, gt), k=1)
    return float(dist.mean())
