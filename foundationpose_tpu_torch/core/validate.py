"""Input validation at the public API boundaries.

The port's own copy of foundationpose_tpu/core/validate.py: counterpart of the reference's native-side input checking
(CHECK_CUDA/CHECK_CONTIGUOUS/CHECK_INPUT macros, bundlesdf/mycuda/common.h:
17-19, gridencoder.cu:15-18, plus the runtime guards of estimater.py:185-189
and datareader.py:204): a wrong-shaped or wrong-unit input would otherwise become either an opaque
shape error deep in the pipeline or — worse — a silently garbage pose.

Checks raise ValueError with actionable messages; unit heuristics only WARN
(the reference warns and auto-converts in file_processing.py:113-125 — depth
conversion is the caller's decision, not ours).
"""

from __future__ import annotations

import logging

import numpy as np
import torch


def check_intrinsics(K, name="K"):
    K = np.asarray(K)
    if K.shape != (3, 3):
        raise ValueError(f"{name} must be (3,3), got {K.shape}")
    if not np.isfinite(K).all():
        raise ValueError(f"{name} contains non-finite values")
    if K[0, 0] <= 0 or K[1, 1] <= 0:
        raise ValueError(f"{name} focal lengths must be positive: {K[0,0]}, {K[1,1]}")
    if abs(K[2, 0]) > 1e-9 or abs(K[2, 1]) > 1e-9 or abs(K[2, 2] - 1.0) > 1e-6:
        raise ValueError(f"{name} bottom row must be [0,0,1], got {K[2]}")
    return K


def check_rgbd(rgb, depth, name="register"):
    rgb = np.asarray(rgb)
    depth = np.asarray(depth)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"{name}: rgb must be (H,W,3), got {rgb.shape}")
    if depth.ndim != 2:
        raise ValueError(f"{name}: depth must be (H,W), got {depth.shape}")
    if rgb.shape[:2] != depth.shape:
        raise ValueError(
            f"{name}: rgb {rgb.shape[:2]} and depth {depth.shape} sizes differ"
        )
    if not np.isfinite(depth).all():
        raise ValueError(f"{name}: depth contains non-finite values")
    valid = depth > 0.001
    if valid.any():
        med = float(np.median(depth[valid]))
        # depth in millimeters fed as meters is the classic unit bug
        # (reference mm->m heuristic, file_processing.py:122-125)
        if med > 100.0:
            logging.warning(
                "%s: median depth %.1f looks like millimeters — expected "
                "meters (divide by 1000?)", name, med,
            )
    else:
        logging.warning("%s: depth has no valid (>1mm) pixels", name)
    return rgb, depth


def check_mask(mask, depth_shape, name="register"):
    """The mask as given where its shape is the depth's: a bool or uint8
    tensor stays a tensor (on its device, nothing read back), anything else
    becomes a numpy array."""
    if torch.is_tensor(mask):
        if mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"{name}: a tensor mask must be bool or uint8, got {mask.dtype}")
    else:
        mask = np.asarray(mask)
    if tuple(mask.shape) != tuple(depth_shape):
        raise ValueError(
            f"{name}: mask {tuple(mask.shape)} does not match depth {tuple(depth_shape)}"
        )
    return mask


def check_pose(pose, name="pose"):
    pose = np.asarray(pose)
    if pose.shape != (4, 4):
        raise ValueError(f"{name} must be (4,4), got {pose.shape}")
    if not np.isfinite(pose).all():
        raise ValueError(f"{name} contains non-finite values")
    R = pose[:3, :3]
    err = np.abs(R @ R.T - np.eye(3)).max()
    if err > 1e-2:
        raise ValueError(f"{name} rotation is not orthonormal (err {err:.2e})")
    return pose
