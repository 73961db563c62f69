"""SDF training losses + depth-band volume rendering weights.

Counterpart of foundationpose_tpu/field/losses.py, after the reference's
get_masks / get_sdf_loss (nerf_helpers.py:398-428: free-space, truncation
band ``(z + sdf*trunc - d)^2``, empty losses) and the depth-guided
sdf2weights compositing (nerf_runner.raw2outputs :849-886).
"""

from __future__ import annotations

import torch


def sdf_losses(z_vals, target_d, sdf, trunc, sample_weights, near, far,
               neg_trunc_ratio=1.0, fs_sdf=1.0):
    """All inputs in the normalized scene scale.

    z_vals: (N,S); target_d: (N,); sdf: (N,S); sample_weights: (N,S)
    (ray weights x valid-sample mask). Returns (fs_loss, sdf_loss, empty_loss,
    front_mask, sdf_mask), unweighted by the cfg loss weights.
    """
    d = target_d[:, None]
    valid_depth = (d >= near) & (d <= far)
    front = z_vals < d - trunc
    back = z_vals > d + trunc * neg_trunc_ratio
    sdf_mask = (~front) & (~back) & valid_depth

    # free space: rays whose depth is invalid (beyond far) should predict
    # sdf >= fs_sdf everywhere (nerf_helpers.py:418-420)
    fs_m = (d > far) & (sdf < fs_sdf)
    fs_loss = torch.mean(((sdf - fs_sdf) * fs_m) ** 2 * sample_weights)

    # empty space in front of the surface: sdf should saturate at 1
    empty_m = front & (d <= far) & (sdf < 1)
    empty_loss = torch.mean(torch.abs(sdf - 1.0) * empty_m * sample_weights)

    # truncation band: z + sdf*trunc == observed depth (nerf_helpers.py:424)
    sdf_loss = torch.mean(
        ((z_vals + sdf * trunc) * sdf_mask - d * sdf_mask) ** 2 * sample_weights
    )
    return fs_loss, sdf_loss, empty_loss, front, sdf_mask


def depth_band_weights(z_vals, depth, trunc, sdf_lambda, far, neg_trunc_ratio=1.0):
    """Compositing weights centered on observed depth
    (reference sdf2weights, nerf_runner.py:869-878)."""
    d = depth[:, None]
    s = (d - z_vals) / trunc
    w = torch.sigmoid(s * sdf_lambda) * torch.sigmoid(-s * sdf_lambda)
    band = (z_vals - d <= trunc * neg_trunc_ratio) & (z_vals - d >= -trunc)
    invalid = d > far
    zero = torch.zeros_like(w)
    w = torch.where(invalid, zero, torch.where(band, w, zero))
    return w / (w.sum(dim=-1, keepdim=True) + 1e-10)


def render_rgb(raw, weights):
    """raw: (N,S,4); weights: (N,S). Sigmoid colors composited."""
    rgb = torch.sigmoid(raw[..., :3])
    return (weights[..., None] * rgb).sum(dim=-2)
