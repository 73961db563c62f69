"""Image-space ops: depth-map stencils and the crop warp.

Counterpart of foundationpose_tpu/ops/image.py (``dilate_mask``,
``erode_depth``, ``bilateral_filter_depth``, ``warp_perspective``,
``warp_crop_affine``). ``warp_perspective`` is the general 3x3 resample;
no path of the port calls it, and the tests hold ``warp_crop_affine``
against it. The
stencils are 5x5 shift stacks accumulated in the same order as the JAX
functions; the warp is the gather form of the separable resample (a gather is
cheap on a GPU), with sample positions bit-identical to the ones the JAX
function takes from ``inv(tf)``, so ``.5`` ties resolve the same way. All
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from foundationpose_tpu_torch.core.geometry import as_f32


def _shift_views(img, radius, fill=0.0):
    """Yield (dv, du, shifted, in_bounds) over the (2r+1)^2 window:
    shifted[i,j] = img[i+dv, j+du] (``fill`` outside), in_bounds as 0/1."""
    H, W = img.shape
    r = radius
    padded = F.pad(img, (r, r, r, r), value=fill)
    ones = F.pad(torch.ones_like(img), (r, r, r, r))
    for dv in range(-r, r + 1):
        for du in range(-r, r + 1):
            sl = (slice(r + dv, r + dv + H), slice(r + du, r + du + W))
            yield dv, du, padded[sl], ones[sl]


def dilate_mask(mask, radius=10):
    """Binary dilation of a (H,W) or (B,H,W) mask by a (2r+1)^2 square element
    (windowed max), per image."""
    m = torch.as_tensor(mask).float()
    batched = m.ndim == 3
    if not batched:
        m = m[None]
    k = 2 * radius + 1
    out = F.max_pool2d(m[:, None], k, stride=1, padding=radius)[:, 0] > 0.5
    return out if batched else out[0]


def erode_depth(depth, radius=2, depth_diff_thres=0.001, ratio_thres=0.8, zfar=100.0):
    """Zero a pixel when >ratio_thres of its in-bounds (2r+1)^2 neighbourhood
    is invalid or differs from it by more than depth_diff_thres."""
    d = as_f32(depth)
    bad = torch.zeros_like(d)
    total = torch.zeros_like(d)
    for _, _, nb, inb in _shift_views(d, radius):
        is_bad = (nb < 0.001) | (nb >= zfar) | ((nb - d).abs() > depth_diff_thres)
        bad = bad + inb * is_bad.float()
        total = total + inb
    center_invalid = (d < 0.001) | (d >= zfar)
    return torch.where((bad / total > ratio_thres) | center_invalid, torch.zeros_like(d), d)


def bilateral_filter_depth(depth, radius=2, zfar=100.0, sigma_d=2.0, sigma_r=100000.0):
    """Mean-gated bilateral depth filter: neighbourhood mean over valid
    depths; contributions only from neighbours valid and within 0.01 m of the
    mean; Gaussian space x range weights."""
    d = as_f32(depth)
    mean_sum = torch.zeros_like(d)
    mean_cnt = torch.zeros_like(d)
    shifts = []
    for dv, du, nb, inb in _shift_views(d, radius):
        valid = inb * ((nb >= 0.001) & (nb < zfar)).float()
        mean_sum = mean_sum + valid * nb
        mean_cnt = mean_cnt + valid
        shifts.append((dv, du, nb, valid))
    mean_depth = mean_sum / mean_cnt.clamp_min(1.0)

    wsum = torch.zeros_like(d)
    acc = torch.zeros_like(d)
    for dv, du, nb, valid in shifts:
        near_mean = ((nb - mean_depth).abs() < 0.01).float()
        w = torch.exp(
            -(du * du + dv * dv) / (2.0 * sigma_d * sigma_d)
            - (d - nb) ** 2 / (2.0 * sigma_r * sigma_r)
        )
        w = w * valid * near_mean
        wsum = wsum + w
        acc = acc + w * nb
    return torch.where(
        (wsum > 0) & (mean_cnt > 0), acc / wsum.clamp_min(1e-12), torch.zeros_like(d)
    )


def warp_perspective(img, tf, out_size, mode="bilinear"):
    """Resample ``img`` (H,W,C) or (H,W) under 3x3 transforms ``tf`` (B,3,3)
    or (3,3) that map SOURCE pixel coords to DESTINATION pixel coords. Output
    pixel (i,j) samples the source at ``tf^-1 @ (j, i, 1)`` (dehomogenised) in
    index space; reads outside are zero. Output (B,out_h,out_w,C) float32."""
    tf = as_f32(tf)
    img = as_f32(img, tf.device)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    single = tf.ndim == 2
    if single:
        tf = tf[None]
    H, W, _ = img.shape
    out_h, out_w = out_size
    inv = torch.linalg.inv(tf)  # dest -> src
    ii, jj = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=tf.device),
                            torch.arange(out_w, dtype=torch.float32, device=tf.device),
                            indexing="ij")
    dst = torch.stack([jj, ii, torch.ones_like(jj)], dim=-1)  # (h,w,3)
    src = dst[None] @ inv[:, None].transpose(-1, -2)  # (B,h,w,3)
    z = src[..., 2]
    x = src[..., 0] / z.abs().clamp_min(1e-12) * torch.sign(z)
    y = src[..., 1] / z.abs().clamp_min(1e-12) * torch.sign(z)
    if mode == "nearest":
        taps = [(torch.round(x), torch.round(y), None)]
    else:
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        taps = [(x0 + dx, y0 + dy, (tx if dx else 1 - tx) * (ty if dy else 1 - ty))
                for dy in (0, 1) for dx in (0, 1)]
    out = 0.0
    for xi, yi, w in taps:
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        val = torch.where(inb[..., None], val, torch.zeros_like(val))
        out = out + (val if w is None else val * w[..., None])
    if squeeze:
        out = out[..., 0]
    return out[0] if single else out


def _axis_taps(pos, size, mode):
    """Taps along one axis for continuous source positions ``pos`` (B,out).
    Returns a list of (index (B,out) long, clipped; weight (B,out) float) —
    one tap for nearest, two for bilinear; an out-of-bounds tap has weight 0
    (zero padding)."""
    if mode == "nearest":
        idx = torch.round(pos)
        inb = (idx >= 0) & (idx <= size - 1)
        return [(idx.clamp(0, size - 1).long(), inb.float())]
    p0 = torch.floor(pos)
    frac = pos - p0
    taps = []
    for off, w in ((0.0, 1.0 - frac), (1.0, frac)):
        idx = p0 + off
        inb = (idx >= 0) & (idx <= size - 1)
        taps.append((idx.clamp(0, size - 1).long(), w * inb.float()))
    return taps


def warp_crop_affine(img, tf, out_size, mode="bilinear"):
    """Resample ``img`` (H,W,C) or (H,W) under the scale + translation crop
    transforms ``tf`` (B,3,3) (source pixel -> destination pixel, from
    ``compute_crop_window_tf_batch``). Output pixel (i,j) samples the source
    at ``inv(tf) @ (j, i, 1)`` in index space; reads outside are zero.
    Output (B,out_h,out_w,C) float32.
    """
    tf = as_f32(tf)
    img = as_f32(img, tf.device)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, _ = img.shape
    single = tf.ndim == 2
    if single:
        tf = tf[None]
    out_h, out_w = out_size
    # dest->src. The JAX function inverts with ``jnp.linalg.inv`` (an LU solve),
    # which for these upper-triangular matrices evaluates to 1/s on the
    # diagonal and -t * (1/s) for the offset; that exact arithmetic is
    # written out here (``torch.linalg.inv`` rounds the offset differently),
    # so sample positions are bit-identical and ``.5`` ties resolve the same
    # way — crop windows routinely land on exact half-pixel centres.
    dev = tf.device
    inv_sx, inv_sy = 1.0 / tf[:, 0:1, 0], 1.0 / tf[:, 1:2, 1]
    off_x, off_y = -tf[:, 0:1, 2] * inv_sx, -tf[:, 1:2, 2] * inv_sy
    # position = j * (1/s) + offset as ONE fused multiply-add (the compiled
    # JAX function contracts it): the float64 product of two float32 values
    # is exact, so rounding the float64 sum once gives the FMA result
    def fma_positions(n, scale, offset):
        j = torch.arange(n, dtype=torch.float64, device=dev)[None]
        return (j * scale.double() + offset.double()).float()

    xs = fma_positions(out_w, inv_sx, off_x)
    ys = fma_positions(out_h, inv_sy, off_y)
    out = 0.0
    for xi, wx in _axis_taps(xs, W, mode):
        col = 0.0
        for yi, wy in _axis_taps(ys, H, mode):
            val = img[yi[:, :, None], xi[:, None, :]]  # (B,out_h,out_w,C)
            col = col + val * wy[:, :, None, None]
        out = out + col * wx[:, None, :, None]
    if squeeze:
        out = out[..., 0]
    return out[0] if single else out
