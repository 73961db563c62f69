"""Least time of one render call (K1s + K1r): the bytes it must move over
the memory rate against its float32 operations over the float32 rate,
whichever is larger.

Bytes: every input read once (vertices, normals, faces, poses, intrinsics,
crop transforms, texture and uv or vertex colours) and every output written
once (rgb, xyz, depth as float32, the mask as one byte, normals when asked).
Operations: per vertex and per face of every pose the setup's arithmetic,
and per (pixel, face) pair that the inputs need tested, the test and the 1/z
score. Those pairs are counted on the inputs: a valid face's area in crop
pixels, for faces whose bounding box lies inside the crop; a face that leaves
the crop counts nothing, and neither does the per-pixel attribute pass, so
the count is low and the bound no higher than the work needs. The per-unit
operation counts are those the engine's own bound model uses.
"""

import torch

OPS_PER_VERTEX = 40
OPS_PER_FACE = 220
OPS_PER_PAIR = 15 + 6


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def pair_count(mesh, poses, K, tfs, hw, cull):
    """Pixel x face pairs the inputs need: the summed crop-pixel area of the
    valid faces lying inside the crop."""
    H, W = hw
    R, t = poses[:, :3, :3].float(), poses[:, :3, 3].float()
    faces = mesh["faces"].long()
    v = mesh["pos"][None].float() @ R.transpose(1, 2) + t[:, None]
    uvw = v @ K.float().T
    uv = uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)
    uv = uv @ tfs[:, :2, :2].float().transpose(1, 2) + tfs[:, None, :2, 2].float()
    xy, z = uv[:, faces], v[..., 2][:, faces]
    e1, e2 = xy[:, :, 1] - xy[:, :, 0], xy[:, :, 2] - xy[:, :, 0]
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    ok = (det.abs() > 1e-12) & (z > 1e-3).all(-1)
    ok &= (xy[..., 0].amin(-1) >= 0) & (xy[..., 0].amax(-1) <= W - 1)
    ok &= (xy[..., 1].amin(-1) >= 0) & (xy[..., 1].amax(-1) <= H - 1)
    if cull:
        tri = v[:, faces]
        n = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1)
        ok &= (n * tri.mean(dim=2)).sum(-1) < 0
    return float((det.abs() * 0.5 * ok).double().sum())


def bound(call, peaks):
    """``call``: the render call's inputs as the spans keep them ({mesh,
    poses, K, tfs, hw, cull, with_normal}). Returns (seconds, bytes,
    operations)."""
    mesh, poses = call["mesh"], call["poses"]
    B = poses.shape[0]
    H, W = call["hw"]
    V, F = mesh["pos"].shape[0], mesh["faces"].shape[0]
    colour = _nbytes(mesh.get("tex"), mesh.get("uv"), mesh.get("vertex_color"))
    read = (_nbytes(mesh["pos"], mesh["vnormals"], mesh["faces"]) + B * 16 * 4 + 9 * 4
            + B * 9 * 4 + colour)
    per_pixel = 12 + 12 + 4 + 1 + (12 if call.get("with_normal") else 0)
    nbytes = read + B * H * W * per_pixel
    ops = (B * (V * OPS_PER_VERTEX + F * OPS_PER_FACE)
           + OPS_PER_PAIR * pair_count(mesh, poses, call["K"], call["tfs"], (H, W), call["cull"]))
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_flops"]), nbytes, ops
