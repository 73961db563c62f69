"""Crop-batch construction for refinement and scoring.

Counterpart of foundationpose_tpu/engine/crop.py::make_crop_batch:
per-hypothesis crop transforms, rendering straight into the crop windows
(the CUDA rasterizer on the card, its plain version on the CPU), warping the
observed rgb/xyz into the same windows, then centring the xyz maps on each
hypothesis translation and scaling by the mesh radius.

The observed side is warped in float32. ``validB`` still travels as its own
exactly-warped 0/1 channel, and consumers read it instead of re-thresholding
z — the contract the JAX package states for its reduced-precision warp.
"""

from __future__ import annotations

import torch

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.ops import image as imops
from foundationpose_tpu_torch.ops import raster_cuda
from foundationpose_tpu_torch.utils.profiling import span


def make_crop_batch(
    mesh_tensors,
    poses,
    K,
    rgb,
    xyz_map,
    mesh_diameter,
    crop_ratio=1.2,
    out_size=160,
    normalize_xyz=True,
    z_invalid_thres=0.001,
    use_normal=False,
    backface_cull=False,
    gate_px=0,
):
    """Build network inputs for a batch of pose hypotheses.

    Args:
      mesh_tensors: from ``ops.raster.make_mesh_tensors``.
      poses: (N,4,4) hypotheses (object-in-camera, centred mesh frame).
      K: (3,3); rgb: (H,W,3) float in [0,255]; xyz_map: (H,W,3) cam-space.
      z_invalid_thres: 0.001 for the refiner path, 0.1 for the scorer path.
      gate_px: zero observed pixels beyond this many crop pixels of each
        hypothesis's rendered silhouette (0 = off).

    Returns dict with inputA/inputB (N,S,S,6) [rgb|xyz] network inputs plus
    the raw crops, crop transforms, render mask and ``validB``.
    """
    S = out_size
    dev = mesh_tensors["pos"].device
    n = len(poses)
    with span("crop.render", n, S):
        poses = geo.as_f32(poses, dev)
        K = geo.as_f32(K, dev)
        tfs = geo.compute_crop_window_tf_batch(poses, K, crop_ratio, mesh_diameter, (S, S))
        r = raster_cuda.render_crops(
            mesh_tensors, poses, K, tfs, out_hw=(S, S), use_light=True,
            backface_cull=backface_cull, with_normal=use_normal,
        )
    with span("crop.observe", n):
        rgb = geo.as_f32(rgb, dev)
        xyz_map = geo.as_f32(xyz_map, dev)
        rgbA = r["rgb"]  # already [0,1]
        xyzA = r["xyz"]
        t = poses[:, :3, 3]

        rgbB = imops.warp_crop_affine(rgb, tfs, (S, S), mode="bilinear") / 255.0
        # validity rides along as a fourth, exactly-warped 0/1 channel
        valid_src = (xyz_map[..., 2:] >= z_invalid_thres).float()
        w = imops.warp_crop_affine(
            torch.cat([xyz_map, valid_src], dim=-1), tfs, (S, S), mode="nearest"
        )
        xyzB = w[..., :3]
        validB = w[..., 3:] > 0.5

        if gate_px:
            # per-hypothesis silhouette gating of the OBSERVED side: tracking has
            # no segmentation mask, and the candidate's own dilated silhouette is
            # the best available object prior; gated-away depth reads as holes
            g = imops.dilate_mask(r["mask"], int(gate_px))[..., None]
            rgbB = rgbB * g
            xyzB = torch.where(g, xyzB, torch.zeros_like(xyzB))
            validB = validB & g

        def normalize(xyz, thres, valid=None):
            invalid = xyz[..., 2:3] < thres  # (N,S,S,1)
            if valid is not None:
                invalid = invalid | ~valid
            centered = xyz - t[:, None, None, :]
            if not normalize_xyz:
                return centered
            radius = mesh_diameter / 2.0
            scaled = centered / radius
            bad = invalid | (scaled.abs() >= 2)  # per-channel
            return torch.where(bad, torch.zeros_like(scaled), scaled)

        xyzA_n = normalize(xyzA, z_invalid_thres)
        xyzB_n = normalize(xyzB, z_invalid_thres, valid=validB)

        out = {
            "inputA": torch.cat([rgbA, xyzA_n], dim=-1),
            "inputB": torch.cat([rgbB, xyzB_n], dim=-1),
            "rgbA": rgbA,
            "rgbB": rgbB,
            "depthA": r["depth"],
            "tf_to_crops": tfs,
            "mask": r["mask"],
            "validB": validB,
        }
        if use_normal:
            out["normalA"] = r["normal"]
        return out
