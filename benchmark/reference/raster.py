"""Crop-space triangle rasterizer, plain: every pixel against every face.

Vertices go to the camera, through K and through each pose's crop transform
into crop pixels; barycentrics are affine in the pixel coordinates, so a
chunk of faces against all pixels is one matmul. Visibility keeps, per pixel,
the largest interpolated 1/z over the faces that hold it (ties to the lower
face index); attributes are interpolated from the winner, perspective-correct.
"""

import numpy as np
import torch

ZNEAR = 0.001


def mesh_tensors(vertices, faces, normals, uv=None, texture=None, colors=None, device="cpu"):
    """Tensors of a mesh (numpy float64 vertices / normals, int faces; a
    uint8 texture with per-vertex uv whose v runs up, or uint8 per-vertex
    colours)."""
    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    out = {"pos": put(vertices, torch.float32), "faces": put(faces, torch.int64),
           "vnormals": put(normals, torch.float32)}
    if texture is not None:
        uvf = np.asarray(uv, np.float64).copy()
        uvf[:, 1] = 1.0 - uvf[:, 1]
        out["tex"] = put(np.asarray(texture, np.float64) / 255.0, torch.float32)
        out["uv"] = put(uvf, torch.float32)
    else:
        out["color"] = put(np.asarray(colors, np.float64) / 255.0, torch.float32)
    return out


def _coeffs(xy, det):
    x0, y0, x1, y1, x2, y2 = (xy[..., i, j] for i in range(3) for j in range(2))
    inv = 1.0 / torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
    rows = [
        [(y1 - y2) * inv, (y2 - y0) * inv, (y0 - y1) * inv],
        [(x2 - x1) * inv, (x0 - x2) * inv, (x1 - x0) * inv],
        [(x1 * y2 - x2 * y1) * inv, (x2 * y0 - x0 * y2) * inv, (x0 * y1 - x1 * y0) * inv],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _setup(mt, poses, K, tfs, cull):
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    faces = mt["faces"]
    v_cam = mt["pos"][None] @ R.transpose(1, 2) + t[:, None]
    uvw = v_cam @ K.T
    uv = uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)
    uv = uv @ tfs[:, :2, :2].transpose(1, 2) + tfs[:, None, :2, 2]
    xy = uv[:, faces]
    z = v_cam[..., 2][:, faces]
    e1, e2 = xy[..., 1, :] - xy[..., 0, :], xy[..., 2, :] - xy[..., 0, :]
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    valid = (det.abs() > 1e-12) & (z > ZNEAR).all(dim=-1)
    if cull:
        tri = v_cam[:, faces]
        n = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1)
        valid = valid & ((n * tri.mean(dim=2)).sum(dim=-1) < 0.0)
    n_cam = mt["vnormals"][None] @ R.transpose(1, 2)
    diffuse = (n_cam * -torch.tensor([0.0, 0.0, 1.0], device=poses.device)).sum(-1).clamp(0, 1)
    return v_cam, n_cam, diffuse, _coeffs(xy, det), 1.0 / z.clamp_min(ZNEAR), valid


def _interp(pw, attr, vids):
    B, P = pw.shape[:2]
    C = attr.shape[-1]
    out = 0.0
    for k in range(3):
        out = out + pw[..., k:k + 1] * torch.gather(attr, 1, vids[..., k][..., None].expand(B, P, C))
    return out


def _texture(tex, uv):
    Ht, Wt = tex.shape[:2]
    x, y = uv[:, 0] * Wt - 0.5, uv[:, 1] * Ht - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = (x0 + dx).clamp(0, Wt - 1).long()
            yi = (y0 + dy).clamp(0, Ht - 1).long()
            out = out + tex[yi, xi] * (((1 - tx) if dx == 0 else tx)
                                       * ((1 - ty) if dy == 0 else ty))[:, None]
    return out


def _render(mt, poses, K, tfs, H, W, cull, with_normal, face_chunk):
    dev = poses.device
    B, P = poses.shape[0], H * W
    faces = mt["faces"]
    F = faces.shape[0]
    v_cam, n_cam, diffuse, coeff, invz, valid = _setup(mt, poses, K, tfs, cull)
    ii, jj = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([jj.reshape(-1), ii.reshape(-1), torch.ones(P, device=dev)], -1)
    best = torch.full((B, P), -1.0, device=dev)
    best_f = torch.zeros((B, P), dtype=torch.long, device=dev)
    for f0 in range(0, F, face_chunk):
        c = coeff[:, f0:f0 + face_chunk]
        n = c.shape[1]
        w = (pix @ c.permute(0, 2, 1, 3).reshape(B, 3, n * 3)).reshape(B, P, n, 3)
        inside = (w >= -1e-6).all(dim=-1) & valid[:, None, f0:f0 + n]
        score = torch.where(inside, (w * invz[:, None, f0:f0 + n]).sum(-1), torch.full_like(w[..., 0], -1.0))
        c_best, c_idx = score.max(dim=-1)
        take = c_best > best
        best = torch.where(take, c_best, best)
        best_f = torch.where(take, c_idx + f0, best_f)
    hit = best > 0.0
    vids = faces[best_f]
    cw = torch.gather(coeff.reshape(B, F, 9), 1, best_f[..., None].expand(B, P, 9)).reshape(B, P, 3, 3)
    w = pix[None, :, 0, None] * cw[:, :, 0] + pix[None, :, 1, None] * cw[:, :, 1] + cw[:, :, 2]
    vz = torch.gather(v_cam[..., 2], 1, vids.reshape(B, -1)).reshape(B, P, 3)
    pw = w / vz.clamp_min(ZNEAR)
    pw = pw / pw.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    xyz = _interp(pw, v_cam, vids)
    if "tex" in mt:
        uvt = _interp(pw, mt["uv"][None].expand(B, -1, -1), vids)
        color = _texture(mt["tex"], uvt.reshape(-1, 2)).reshape(B, P, 3)
    else:
        color = _interp(pw, mt["color"][None].expand(B, -1, -1), vids)
    diff = _interp(pw, diffuse[..., None], vids)[..., 0]
    color = (color * 0.8 + diff[..., None] * color * 0.5).clamp(0.0, 1.0)
    hf = hit[..., None].float()
    out = {"rgb": (color * hf).reshape(B, H, W, 3), "xyz": (xyz * hf).reshape(B, H, W, 3),
           "mask": hit.reshape(B, H, W)}
    if with_normal:
        nrm = _interp(pw, n_cam, vids)
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        out["normal"] = (nrm * hf).reshape(B, H, W, 3)
    return out


def render(mt, poses, K, tfs, hw, cull=False, with_normal=False, face_chunk=256, pose_chunk=8):
    """Render B poses of one mesh into their (H, W) crop windows: ``rgb``
    lit (ambient 0.8 + 0.5 x diffuse, light along the view axis) in [0, 1],
    ``xyz`` camera-space, ``mask``, and ``normal`` when asked."""
    H, W = hw
    parts = [_render(mt, poses[i:i + pose_chunk], K, tfs[i:i + pose_chunk], H, W, cull,
                     with_normal, face_chunk) for i in range(0, poses.shape[0], pose_chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
