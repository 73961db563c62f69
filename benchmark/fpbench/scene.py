"""Seeded scenes: a textured asymmetric object on a textured table beside
two boxes, seen by a 480x640 camera, rendered by the reference rasterizer
with depth noise and holes.

The object is a UV sphere of ``faces`` triangles (33 rings x 64 columns, seam
and pole vertices kept apart for the texture) pushed out by seeded Gaussian
bumps and stretched on three axes, scaled to the configured diameter, with a
seeded ``texture`` x ``texture`` texture. World z is up; the table is z = 0.
"""

import numpy as np
import torch
import torch.nn.functional as F

from reference import raster

SKY_RGB = 160.0


def _normals(v, f):
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    out = np.zeros_like(v)
    for k in range(3):
        np.add.at(out, f[:, k], n)
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


def _texture(gen, size, device):
    """uint8 (size, size, 3): a smooth colour field, a coarse random tiling
    and diagonal stripes, so that every view has texture to match."""
    smooth = F.interpolate(torch.rand(1, 3, 6, 6, generator=gen, device=device), size=(size, size),
                           mode="bicubic", align_corners=False)
    tiles = F.interpolate(torch.rand(1, 3, 24, 24, generator=gen, device=device), size=(size, size),
                          mode="nearest")
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device),
                            indexing="ij")
    stripes = (((xx + 2 * yy) // 23) % 2).float()[None, None]
    img = 0.5 * smooth + 0.35 * tiles + 0.15 * stripes
    return (img[0].permute(1, 2, 0).clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()


def make_object(seed, cfg, device):
    """The object's arrays (float64 vertices and normals, int32 faces, uv,
    uint8 texture), its size set by the reference's diameter formula."""
    from reference.pose import diameter

    rng = np.random.default_rng([seed % 2**64, 1])
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    rings, cols = cfg["rings"], cfg["columns"]
    th = np.pi * np.arange(rings + 1) / rings
    ph = 2 * np.pi * np.arange(cols + 1) / cols
    d = np.stack([np.sin(th)[:, None] * np.cos(ph)[None], np.sin(th)[:, None] * np.sin(ph)[None],
                  np.cos(th)[:, None] * np.ones_like(ph)[None]], axis=-1).reshape(-1, 3)
    centres = rng.normal(size=(6, 3))
    centres /= np.linalg.norm(centres, axis=-1, keepdims=True)
    r = 1.0 + (rng.uniform(-0.25, 0.45, 6)[None] * np.exp(
        -np.sum((d[:, None] - centres[None]) ** 2, -1) / 0.35)).sum(-1)
    v = d * r[:, None] * np.array([1.0, rng.uniform(0.6, 0.8), rng.uniform(0.4, 0.55)])
    idx = np.arange((rings + 1) * (cols + 1)).reshape(rings + 1, cols + 1)
    faces = []
    for i in range(rings):
        for j in range(cols):
            a, b, c, e = idx[i, j], idx[i + 1, j], idx[i + 1, j + 1], idx[i, j + 1]
            if i > 0:
                faces.append([a, c, e])
            if i < rings - 1:
                faces.append([a, b, c])
    faces = np.asarray(faces, np.int32)
    if len(faces) != cfg["faces"]:
        raise ValueError(f"{rings} rings x {cols} columns give {len(faces)} faces, "
                         f"not {cfg['faces']}")
    v = v - (v.min(0) + v.max(0)) / 2.0
    v *= cfg["diameter_m"] / diameter(v)
    uv = np.stack([np.tile(np.arange(cols + 1) / cols, rings + 1),
                   1.0 - np.repeat(np.arange(rings + 1) / rings, cols + 1)], -1)
    return {"vertices": v, "faces": faces, "normals": _normals(v, faces), "uv": uv,
            "texture": _texture(gen, cfg["texture"], device)}


def make_table(seed, device, half=1.0, n=20):
    gen = torch.Generator(device=device).manual_seed((seed + 7) % 2**63)
    g = np.linspace(-half, half, n + 1)
    xx, yy = np.meshgrid(g, g, indexing="xy")
    v = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], -1)
    idx = np.arange(v.shape[0]).reshape(n + 1, n + 1)
    f = []
    for i in range(n):
        for j in range(n):
            a, b, c, e = idx[i, j], idx[i, j + 1], idx[i + 1, j + 1], idx[i + 1, j]
            f += [[a, b, c], [a, c, e]]
    uv = np.stack([(xx.ravel() + half) / (2 * half), (yy.ravel() + half) / (2 * half)], -1)
    return {"vertices": v, "faces": np.asarray(f, np.int32), "normals": np.tile([0.0, 0, 1], (len(v), 1)),
            "uv": uv, "texture": _texture(gen, 256, device)}


def make_boxes(rng, avoid_radius):
    """Two boxes on the table, each outside ``avoid_radius`` of the origin."""
    verts, faces, normals, colors = [], [], [], []
    quads = [([0, 1, 2, 3], [0, 0, -1]), ([4, 7, 6, 5], [0, 0, 1]), ([0, 4, 5, 1], [0, -1, 0]),
             ([1, 5, 6, 2], [1, 0, 0]), ([2, 6, 7, 3], [0, 1, 0]), ([3, 7, 4, 0], [-1, 0, 0])]
    for _ in range(2):
        sx, sy, sz = rng.uniform(0.05, 0.12, 3)
        corners = np.array([[x, y, z] for z in (0, sz) for x, y in
                            ((-sx, -sy), (sx, -sy), (sx, sy), (-sx, sy))]) * [0.5, 0.5, 1]
        yaw = rng.uniform(0, 2 * np.pi)
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        ang, dist = rng.uniform(0, 2 * np.pi), avoid_radius + rng.uniform(0.05, 0.2)
        corners = corners @ Rz.T + [dist * np.cos(ang), dist * np.sin(ang), 0]
        col = rng.integers(30, 230, 3)
        for q, n in quads:
            base = len(verts)
            verts += list(corners[q])
            normals += [Rz @ np.asarray(n, float)] * 4
            colors += [col] * 4
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return {"vertices": np.asarray(verts), "faces": np.asarray(faces, np.int32),
            "normals": np.asarray(normals), "colors": np.asarray(colors, np.uint8)}


def look_at(cam_pos, target):
    """World -> camera (4,4) for a camera at ``cam_pos`` looking at
    ``target`` with world z up (OpenCV axes)."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, y, z])
    T[:3, 3] = -T[:3, :3] @ cam_pos
    return T


def random_rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


class Renderer:
    """Renders frames of one object (with the table and boxes) on the
    device."""

    def __init__(self, obj, table, K, hw, device):
        self.device, self.hw = torch.device(device), tuple(hw)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.obj_v = np.asarray(obj["vertices"])
        self.obj = raster.mesh_tensors(obj["vertices"], obj["faces"], obj["normals"], obj["uv"],
                                       obj["texture"], device=self.device)
        self.table = raster.mesh_tensors(table["vertices"], table["faces"], table["normals"],
                                         table["uv"], table["texture"], device=self.device)

    def _full(self, mt, pose):
        H, W = self.hw
        eye = torch.eye(3, device=self.device)[None]
        p = torch.as_tensor(pose[None], dtype=torch.float32, device=self.device)
        return raster.render(mt, p, self.K, eye, (H, W), face_chunk=128)

    def _window(self, mt, verts, pose):
        """Render into the frame only the box the mesh projects to."""
        H, W = self.hw
        K = self.K.double().cpu().numpy()
        pc = verts @ pose[:3, :3].T + pose[:3, 3]
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        u0, v0 = (np.clip(np.floor(uv.min(0)) - 2, 0, [W - 1, H - 1])).astype(int)
        u1, v1 = (np.clip(np.ceil(uv.max(0)) + 2, 0, [W - 1, H - 1])).astype(int)
        tf = torch.eye(3, device=self.device)
        tf[0, 2], tf[1, 2] = -float(u0), -float(v0)
        p = torch.as_tensor(pose[None], dtype=torch.float32, device=self.device)
        r = raster.render(mt, p, self.K, tf[None], (v1 - v0 + 1, u1 - u0 + 1), face_chunk=128)
        out = {k: torch.zeros((1, H, W) + r[k].shape[3:], dtype=r[k].dtype, device=self.device)
               for k in r}
        for k in r:
            out[k][:, v0:v1 + 1, u0:u1 + 1] = r[k]
        return out

    def frame(self, obj_in_cam, world_to_cam, boxes, gen, noise):
        """uint8 rgb (H,W,3), float32 depth (H,W) in metres, bool mask
        (H,W) of the object's visible pixels."""
        parts = [self._window(self.obj, self.obj_v, obj_in_cam),
                 self._full(self.table, world_to_cam)]
        if boxes is not None:
            parts.append(self._full(boxes, world_to_cam))
        z = torch.stack([torch.where(p["mask"][0], p["xyz"][0, ..., 2],
                                     torch.full_like(p["xyz"][0, ..., 2], np.inf)) for p in parts])
        zmin, who = z.min(dim=0)
        hit = torch.isfinite(zmin)
        rgb = torch.full((*self.hw, 3), SKY_RGB / 255.0, device=self.device)
        for i, p in enumerate(parts):
            sel = (who == i) & hit
            rgb = torch.where(sel[..., None], p["rgb"][0], rgb)
        depth = torch.where(hit, zmin, torch.zeros_like(zmin))
        mask = hit & (who == 0)
        sigma = noise["depth_sigma_m"] + noise["depth_sigma_per_m2"] * depth * depth
        depth = depth + sigma * torch.randn(depth.shape, generator=gen, device=self.device)
        drop = torch.rand(depth.shape, generator=gen, device=self.device) < noise["dropout"]
        H, W = self.hw
        yy, xx = torch.meshgrid(torch.arange(H, device=self.device),
                                torch.arange(W, device=self.device), indexing="ij")
        blobs = torch.rand((noise["holes"], 4), generator=gen, device=self.device)
        for cx, cy, rx, ry in blobs:
            a, b = 4 + 12 * rx, 4 + 12 * ry
            drop |= ((xx - cx * W) / a) ** 2 + ((yy - cy * H) / b) ** 2 < 1.0
        depth = torch.where(drop | ~hit, torch.zeros_like(depth), depth)
        rgb = rgb * 255.0 + noise["rgb_sigma"] * torch.randn(rgb.shape, generator=gen,
                                                             device=self.device)
        rgb = rgb.clamp(0, 255).round().to(torch.uint8)
        return rgb.cpu().numpy(), depth.float().cpu().numpy(), mask.cpu().numpy()
