"""Image-space operations: mask dilation, the depth stencils and the crop
warp. All float32."""

import torch
import torch.nn.functional as F


def dilate(mask, radius):
    """(H,W) or (B,H,W) boolean dilation by a (2r+1) square."""
    m = mask.float()
    batched = m.ndim == 3
    m = m if batched else m[None]
    out = F.max_pool2d(m[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0] > 0.5
    return out if batched else out[0]


def _window(img, r):
    """(dv, du, shifted image, in-bounds 0/1) over the (2r+1)^2 window."""
    H, W = img.shape
    padded = F.pad(img, (r, r, r, r), value=0.0)
    ones = F.pad(torch.ones_like(img), (r, r, r, r))
    for dv in range(-r, r + 1):
        for du in range(-r, r + 1):
            sl = (slice(r + dv, r + dv + H), slice(r + du, r + du + W))
            yield dv, du, padded[sl], ones[sl]


def erode_depth(d, radius=2, diff=0.001, ratio=0.8, zfar=100.0):
    """Zero a pixel whose in-bounds neighbourhood is more than ``ratio``
    invalid or more than ``diff`` away from it."""
    bad = torch.zeros_like(d)
    total = torch.zeros_like(d)
    for _, _, nb, inb in _window(d, radius):
        is_bad = (nb < 0.001) | (nb >= zfar) | ((nb - d).abs() > diff)
        bad = bad + inb * is_bad.float()
        total = total + inb
    drop = (bad / total > ratio) | (d < 0.001) | (d >= zfar)
    return torch.where(drop, torch.zeros_like(d), d)


def bilateral_depth(d, radius=2, zfar=100.0, sigma_d=2.0, sigma_r=100000.0):
    """Bilateral filter over the valid neighbours within 1 cm of the
    neighbourhood's mean depth."""
    mean_sum = torch.zeros_like(d)
    mean_cnt = torch.zeros_like(d)
    taps = []
    for dv, du, nb, inb in _window(d, radius):
        valid = inb * ((nb >= 0.001) & (nb < zfar)).float()
        mean_sum = mean_sum + valid * nb
        mean_cnt = mean_cnt + valid
        taps.append((dv, du, nb, valid))
    mean = mean_sum / mean_cnt.clamp_min(1.0)
    wsum = torch.zeros_like(d)
    acc = torch.zeros_like(d)
    for dv, du, nb, valid in taps:
        w = torch.exp(-(du * du + dv * dv) / (2.0 * sigma_d * sigma_d)
                      - (d - nb) ** 2 / (2.0 * sigma_r * sigma_r))
        w = w * valid * ((nb - mean).abs() < 0.01).float()
        wsum = wsum + w
        acc = acc + w * nb
    return torch.where((wsum > 0) & (mean_cnt > 0), acc / wsum.clamp_min(1e-12),
                       torch.zeros_like(d))


def _taps(pos, size, nearest):
    if nearest:
        idx = torch.round(pos)
        inb = (idx >= 0) & (idx <= size - 1)
        return [(idx.clamp(0, size - 1).long(), inb.float())]
    p0 = torch.floor(pos)
    frac = pos - p0
    out = []
    for off, w in ((0.0, 1.0 - frac), (1.0, frac)):
        idx = p0 + off
        inb = (idx >= 0) & (idx <= size - 1)
        out.append((idx.clamp(0, size - 1).long(), w * inb.float()))
    return out


def warp_crops(img, tf, size, nearest=False):
    """Sample (H,W,C) ``img`` into (B,size,size,C) crops under the scale +
    offset transforms ``tf`` (B,3,3), source -> crop pixels; zero outside.
    Crop pixel (i, j) reads the source at j / s_x - t_x / s_x (and the same
    in y), each position rounded once from the exact product and sum, so
    windows on half-pixel centres resolve ties one way."""
    H, W, _ = img.shape
    inv_sx, inv_sy = 1.0 / tf[:, 0:1, 0], 1.0 / tf[:, 1:2, 1]
    off_x, off_y = -tf[:, 0:1, 2] * inv_sx, -tf[:, 1:2, 2] * inv_sy

    def positions(scale, offset):
        j = torch.arange(size, dtype=torch.float64, device=tf.device)[None]
        return (j * scale.double() + offset.double()).float()

    xs, ys = positions(inv_sx, off_x), positions(inv_sy, off_y)
    out = 0.0
    for xi, wx in _taps(xs, W, nearest):
        col = 0.0
        for yi, wy in _taps(ys, H, nearest):
            col = col + img[yi[:, :, None], xi[:, None, :]] * wy[:, :, None, None]
        out = out + col * wx[:, None, :, None]
    return out
