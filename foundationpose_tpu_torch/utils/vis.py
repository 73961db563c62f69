"""Pose visualization helpers (host-side numpy, no cv2).

Counterpart of foundationpose_tpu/utils/vis.py (reference ``draw_xyz_axis``
Utils.py:675-710, ``draw_posed_3d_box`` :713-749, ``depth_to_vis`` :456-479,
``make_grid_image`` :293-300). The JAX package draws with cv2; here lines are
rasterised in numpy: a pixel is on a line of thickness t when its centre lies
within (t + 1) / 2 of the segment (round caps, no anti-aliasing: the pixels
cv2's ``LINE_AA`` draws at over half intensity, less part of their fringe),
arrowheads follow ``cv2.arrowedLine`` (two strokes
of a tenth of the arrow's length at 45 degrees), and the jet colormap is the
analytic one, within one grey level of ``cv2.COLORMAP_JET``. Comparison
strips carry no score text (the JAX package prints it only when cv2 is
present).
"""

from __future__ import annotations

import numpy as np


def project_3d_to_2d(pt, K, ob_in_cam):
    pt = np.append(np.asarray(pt, dtype=np.float64).reshape(3), 1.0)
    p = K @ (ob_in_cam @ pt)[:3]
    return (p[:2] / p[2]).round().astype(int)


def draw_line(img, p0, p1, color, thickness=1):
    """Draw a segment (x, y pixel coordinates) into ``img`` in place."""
    H, W = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    r = (max(thickness, 1) + 1) / 2.0
    x0 = int(max(np.floor(min(p0[0], p1[0]) - r), 0))
    x1 = int(min(np.ceil(max(p0[0], p1[0]) + r), W - 1))
    y0 = int(max(np.floor(min(p0[1], p1[1]) - r), 0))
    y1 = int(min(np.ceil(max(p0[1], p1[1]) + r), H - 1))
    if x0 > x1 or y0 > y1:
        return img
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    d = p1 - p0
    L2 = float(d @ d)
    t = 0.0 if L2 == 0 else np.clip(((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1]) / L2, 0, 1)
    dist2 = (xs - p0[0] - t * d[0]) ** 2 + (ys - p0[1] - t * d[1]) ** 2
    img[y0:y1 + 1, x0:x1 + 1][dist2 <= r * r] = color
    return img


def draw_arrow(img, p0, p1, color, thickness=1, tip_length=0.1):
    """``cv2.arrowedLine``: the shaft, then two strokes from the tip."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    draw_line(img, p0, p1, color, thickness)
    tip = np.linalg.norm(p0 - p1) * tip_length
    angle = np.arctan2(p0[1] - p1[1], p0[0] - p1[0])
    for a in (angle + np.pi / 4, angle - np.pi / 4):
        q = np.rint(p1 + tip * np.array([np.cos(a), np.sin(a)]))
        draw_line(img, p1, q, color, thickness)
    return img


def draw_xyz_axis(rgb, ob_in_cam, scale=0.1, K=np.eye(3), thickness=3):
    """Draw the object frame axes (x=red, y=green, z=blue) onto an RGB image."""
    img = np.ascontiguousarray(rgb).astype(np.uint8).copy()
    origin = project_3d_to_2d([0, 0, 0], K, ob_in_cam)
    colors = {"x": (255, 0, 0), "y": (0, 255, 0), "z": (0, 0, 255)}
    ends = {"x": [scale, 0, 0], "y": [0, scale, 0], "z": [0, 0, scale]}
    for axis, end in ends.items():
        tip = project_3d_to_2d(end, K, ob_in_cam)
        draw_arrow(img, origin, tip, colors[axis], thickness)
    return img


def draw_posed_3d_box(K, img, ob_in_cam, bbox, line_color=(0, 255, 0), linewidth=2):
    """Wireframe of an axis-aligned (object-frame) box. bbox: (2,3) min/max."""
    img = np.ascontiguousarray(img).astype(np.uint8).copy()
    mn = np.asarray(bbox).min(axis=0)
    mx = np.asarray(bbox).max(axis=0)
    corners = np.array(
        [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])]
    )
    uv = np.stack([project_3d_to_2d(c, K, ob_in_cam) for c in corners])
    edges = [
        (0, 1), (2, 3), (4, 5), (6, 7),  # z edges
        (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
        (0, 4), (1, 5), (2, 6), (3, 7),  # x edges
    ]
    for a, b in edges:
        draw_line(img, uv[a], uv[b], line_color, linewidth)
    return img


def jet_colormap(gray_u8):
    """(...) uint8 -> (..., 3) uint8 RGB through the jet colormap."""
    x = np.arange(256) / 255.0
    lut = np.clip(np.stack([1.5 - np.abs(4 * x - 3), 1.5 - np.abs(4 * x - 2),
                            1.5 - np.abs(4 * x - 1)], axis=-1), 0, 1)
    return np.rint(lut * 255).astype(np.uint8)[np.asarray(gray_u8, np.uint8)]


def depth_to_vis(depth, zmin=None, zmax=None, mode="rgb", inverse=True):
    """Colorize a depth map (reference Utils.py:456-479)."""
    depth = np.asarray(depth, dtype=np.float64)
    zmin = depth.min() if zmin is None else zmin
    zmax = depth.max() if zmax is None else zmax
    if inverse:
        invalid = depth < 0.001
        vis = zmin / (depth + 1e-8)
        vis[invalid] = 0
    else:
        d = depth.clip(zmin, zmax)
        invalid = (d == zmin) | (d == zmax)
        vis = (d - zmin) / max(zmax - zmin, 1e-12)
        vis[invalid] = 1
    if mode == "gray":
        return (vis * 255).clip(0, 255).astype(np.uint8)
    if mode == "rgb":
        return jet_colormap((vis * 255).astype(np.uint8))
    raise ValueError(mode)


def make_grid_image(imgs, nrow, padding=5, pad_value=255):
    """Tile (B,H,W,C) images into a grid (reference Utils.py:293-300)."""
    imgs = [np.asarray(im).astype(np.uint8) for im in imgs]
    H = max(im.shape[0] for im in imgs)
    W = max(im.shape[1] for im in imgs)
    cells = []
    for im in imgs:
        if im.ndim == 2:
            im = np.tile(im[..., None], (1, 1, 3))
        canvas = np.full((H, W, 3), pad_value, np.uint8)
        canvas[: im.shape[0], : im.shape[1]] = im[..., :3]
        cells.append(canvas)
    rows = []
    for i in range(0, len(cells), nrow):
        row = cells[i : i + nrow]
        while len(row) < nrow:
            row.append(np.full((H, W, 3), pad_value, np.uint8))
        pad = np.full((H, padding, 3), pad_value, np.uint8)
        out = row[0]
        for c in row[1:]:
            out = np.concatenate([out, pad, c], axis=1)
        rows.append(out)
    padr = np.full((padding, rows[0].shape[1], 3), pad_value, np.uint8)
    grid = rows[0]
    for r in rows[1:]:
        grid = np.concatenate([grid, padr, r], axis=0)
    return grid


def make_comparison_strip(rendered, observed, pad=2):
    """Side-by-side [render | observed] comparison rows, one per hypothesis —
    the canvas layout of the reference's refine/score debug dumps
    (predict_pose_refine.py:241-293, predict_score.py:27-52).

    rendered/observed: (N,H,W,3) float in [0,1]. Returns one uint8 canvas
    with hypothesis i on row i."""
    rows = []
    for i in range(len(rendered)):
        r = (np.clip(np.asarray(rendered[i]), 0, 1) * 255).astype(np.uint8)
        o = (np.clip(np.asarray(observed[i]), 0, 1) * 255).astype(np.uint8)
        gap = np.full((r.shape[0], pad, 3), 255, np.uint8)
        rows.append(np.concatenate([r, gap, o], axis=1))
    return make_grid_image(rows, nrow=1)
