"""Pose-accuracy metrics: ADD, ADD-S, AUC and trajectory errors (host-side
numpy).

Counterpart of foundationpose_tpu/core/metrics.py (``add_err``,
``adds_err``, ``compute_auc``, ``align_trajectory_se3``, ``ate_rmse``,
``rpe``). ADD-S uses a KD-tree nearest neighbour; the JAX package's chunked
brute force computes the same minimum. The rest is the same float64 numpy.
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


def compute_auc(errs, max_val=0.1, step=0.001):
    """Accuracy-threshold AUC: the recall curve over thresholds
    ``arange(0, max_val+step, step)``, trapezoid-integrated, stopped early
    once recall reaches 1, normalised by ``max_val``."""
    errs = np.sort(np.asarray(errs))
    X = np.arange(0, max_val + step, step)
    Y = np.ones(len(X))
    for i, x in enumerate(X):
        y = (errs <= x).sum() / len(errs)
        Y[i] = y
        if y >= 1:
            break
    return float(np.trapezoid(Y, X) / max_val)


def align_trajectory_se3(pred_t, gt_t):
    """Least-squares SE3 (no scale) aligning pred translations onto gt
    (Horn's method). pred_t/gt_t: (N,3). Returns (R (3,3), t (3,))."""
    pred_t = np.asarray(pred_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    mu_p = pred_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    H = (pred_t - mu_p).T @ (gt_t - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ S @ U.T
    return R, mu_g - R @ mu_p


def ate_rmse(pred_poses, gt_poses, align=True):
    """Absolute trajectory error: RMSE of the translation residuals between
    two (N,4,4) pose sequences, optionally after a global SE3 alignment."""
    pred_t = np.asarray(pred_poses, np.float64)[:, :3, 3]
    gt_t = np.asarray(gt_poses, np.float64)[:, :3, 3]
    if align:
        R, t = align_trajectory_se3(pred_t, gt_t)
        pred_t = pred_t @ R.T + t
    return float(np.sqrt(((pred_t - gt_t) ** 2).sum(axis=-1).mean()))


def rpe(pred_poses, gt_poses, delta=1):
    """Relative pose error over frame gaps of ``delta``: mean translation
    drift (metres) and mean rotation drift (degrees) of
    inv(gt_i^-1 gt_{i+d}) (pred_i^-1 pred_{i+d})."""
    pred = np.asarray(pred_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    terrs, rerrs = [], []
    for i in range(len(pred) - delta):
        dp = np.linalg.inv(pred[i]) @ pred[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ dp
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.degrees(np.arccos(c)))
    return float(np.mean(terrs)), float(np.mean(rerrs))
