"""Batched crop-space triangle rasterizer — plain PyTorch version.

Counterpart of foundationpose_tpu/ops/raster.py (``make_mesh_tensors``,
``render_crops``, ``_bary_coeffs``, ``_signed_area2``, ``_sample_texture``,
``render_full_frame``). This is the plain version of the CUDA kernel in
``ops/raster_cuda.py``: the CPU path of the port and the reference the kernel
is held against on the card. Nothing on the GPU main path calls it.

Renders B pose hypotheses of one mesh directly into their B crop windows:

- work in *crop pixel space*: vertex -> camera space -> K projection -> crop
  transform; integer pixel (v,u) is the ray through continuous (u,v);
- barycentrics are affine in the pixel coords, so all pixels x a chunk of
  faces is one (P,3) @ (3,3Fc) matmul; visibility is a loop over face chunks
  carrying a per-pixel (best 1/z, best face) running argmax with a strict
  ``>`` so ties go to the lowest face index;
- attributes are interpolated once per pixel from the winning face only,
  perspective-correct through 1/z-weighted barycentrics.

``face_setup`` holds the per-(pose, face) arithmetic shared with the CUDA
kernel's setup, so the two differ only in what runs per pixel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.core.geometry import as_f32

ZNEAR = 0.001


def _next_bucket(n: int, base: int) -> int:
    """Smallest base*2^k or base*3*2^(k-1) >= n (1.5-step geometric buckets)."""
    b = base
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


def make_mesh_tensors(mesh, max_faces: int | None = None, dtype=torch.float32,
                      bucket: bool = False, device=None):
    """Prepare device tensors from a ``core.meshio.Mesh``: texture +
    per-vertex uv when textured, vertex colours otherwise (gray 128/255
    fallback), positions / faces / vertex normals. ``max_faces`` bounds the
    triangle axis by vertex-clustering decimation (render-only).

    ``bucket=True`` pads faces to 256*2^k (or 1.5x steps) with degenerate
    zero-faces, vertices to 64*2^k, and texture dims to 256*2^k by edge
    replication with the uv table pre-scaled so sampling is unchanged — the
    JAX package's shape buckets, kept so both packages render the same
    tensors. Degenerate pad faces have zero area and never win.
    """
    device = resolve_device(device)
    if max_faces is not None and len(mesh.faces) > max_faces:
        mesh = meshio.decimate_vertex_clustering(mesh, max_faces)

    verts = np.asarray(mesh.vertices, dtype=np.float64)
    faces = np.asarray(mesh.faces, dtype=np.int64)
    vnormals = np.asarray(
        mesh.vertex_normals if mesh.vertex_normals is not None
        else np.zeros_like(verts)
    )
    has_tex = mesh.texture is not None and mesh.uv is not None
    if has_tex:
        tex = np.asarray(mesh.texture, dtype=np.float64) / 255.0
        uv = np.asarray(mesh.uv, dtype=np.float64).copy()
        uv[:, 1] = 1.0 - uv[:, 1]  # image-row convention
    else:
        if mesh.vertex_colors is not None:
            vc = np.asarray(mesh.vertex_colors[:, :3], dtype=np.float64) / 255.0
        else:
            vc = np.full((len(verts), 3), 128.0 / 255.0)

    if bucket:
        V, F = len(verts), len(faces)
        Vp, Fp = _next_bucket(V, 64), _next_bucket(F, 256)
        verts = np.concatenate([verts, np.zeros((Vp - V, 3))])
        vnormals = np.concatenate([vnormals, np.zeros((Vp - V, 3))])
        faces = np.concatenate([faces, np.zeros((Fp - F, 3), faces.dtype)])
        if has_tex:
            Ht, Wt = tex.shape[:2]
            Hp, Wp = _next_bucket(Ht, 256), _next_bucket(Wt, 256)
            # edge replication keeps the boundary bilinear taps exact
            tex = np.pad(tex, ((0, Hp - Ht), (0, Wp - Wt), (0, 0)), mode="edge")
            # pre-scale uv so u*Wp == u_orig*Wt (sampling unchanged)
            uv = uv * np.array([Wt / Wp, Ht / Hp])
            uv = np.concatenate([uv, np.zeros((Vp - V, 2))])
        else:
            vc = np.concatenate([vc, np.zeros((Vp - V, 3))])

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    out: dict[str, Any] = {
        "pos": put(verts, dtype),
        "faces": put(faces, torch.int32),
        "vnormals": put(vnormals, dtype),
    }
    if has_tex:
        out["tex"] = put(tex, dtype)
        out["uv"] = put(uv, dtype)
    else:
        out["vertex_color"] = put(vc, dtype)
    return out


def _bary_coeffs(xy, det):
    """Affine barycentric coefficient tensor C: [px,py,1] @ C = (w0,w1,w2).

    xy: (..., 3, 2) triangle screen coords; det: (...) signed doubled area.
    Returns C: (..., 3, 3) (rows index px/py/1, cols index w0/w1/w2).
    """
    x0, y0 = xy[..., 0, 0], xy[..., 0, 1]
    x1, y1 = xy[..., 1, 0], xy[..., 1, 1]
    x2, y2 = xy[..., 2, 0], xy[..., 2, 1]
    inv = 1.0 / torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
    a0 = (y1 - y2) * inv
    b0 = (x2 - x1) * inv
    c0 = (x1 * y2 - x2 * y1) * inv
    a1 = (y2 - y0) * inv
    b1 = (x0 - x2) * inv
    c1 = (x2 * y0 - x0 * y2) * inv
    a2 = (y0 - y1) * inv
    b2 = (x1 - x0) * inv
    c2 = (x0 * y1 - x1 * y0) * inv
    row_px = torch.stack([a0, a1, a2], dim=-1)
    row_py = torch.stack([b0, b1, b2], dim=-1)
    row_1 = torch.stack([c0, c1, c2], dim=-1)
    return torch.stack([row_px, row_py, row_1], dim=-2)


def _signed_area2(xy):
    e1 = xy[..., 1, :] - xy[..., 0, :]
    e2 = xy[..., 2, :] - xy[..., 0, :]
    return e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]


def _unit_light(light_dir, device):
    light = as_f32(light_dir, device)
    return light / torch.linalg.norm(light).clamp_min(1e-12)


def face_setup(mesh_tensors, poses, K, crop_tfs, light_dir=(0.0, 0.0, 1.0),
               backface_cull=False):
    """Per-(pose, vertex) and per-(pose, face) quantities of a render call.

    Returns dict: ``v_cam`` (B,V,3) camera-space vertices, ``n_cam`` (B,V,3)
    camera-space vertex normals, ``diff_v`` (B,V) per-vertex Lambertian term
    clip(<n, -light>, 0, 1), ``tri_xy`` (B,F,3,2) crop-pixel triangles,
    ``coeff`` (B,F,3,3) barycentric coefficients, ``invz`` (B,F,3) =
    1/max(z, ZNEAR) per corner, ``valid`` (B,F): |det| > 1e-12, all corners
    beyond ZNEAR and — with ``backface_cull`` — front-facing (outward-CCW
    geometric normal against the view ray; exact for closed CCW meshes).
    """
    verts = mesh_tensors["pos"]
    faces = mesh_tensors["faces"].long()
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    v_cam = verts[None] @ R.transpose(1, 2) + t[:, None]  # (B,V,3)
    z = v_cam[..., 2]
    uvw = v_cam @ K.T
    uv = uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)
    uv_crop = uv @ crop_tfs[:, :2, :2].transpose(1, 2) + crop_tfs[:, None, :2, 2]

    tri_xy = uv_crop[:, faces]  # (B,F,3,2)
    tri_z = z[:, faces]  # (B,F,3)
    det = _signed_area2(tri_xy)
    coeff = _bary_coeffs(tri_xy, det)
    invz = 1.0 / tri_z.clamp_min(ZNEAR)
    valid = (det.abs() > 1e-12) & (tri_z > ZNEAR).all(dim=-1)
    if backface_cull:
        tri_cam = v_cam[:, faces]  # (B,F,3,3)
        nf = torch.linalg.cross(
            tri_cam[:, :, 1] - tri_cam[:, :, 0], tri_cam[:, :, 2] - tri_cam[:, :, 0],
            dim=-1,
        )
        valid = valid & ((nf * tri_cam.mean(dim=2)).sum(dim=-1) < 0.0)

    n_cam = mesh_tensors["vnormals"][None] @ R.transpose(1, 2)
    light = _unit_light(light_dir, verts.device)
    diff_v = (n_cam * (-light)).sum(dim=-1).clamp(0.0, 1.0)
    return {
        "v_cam": v_cam, "n_cam": n_cam, "diff_v": diff_v, "tri_xy": tri_xy,
        "coeff": coeff, "invz": invz, "valid": valid,
    }


def _sample_texture(tex, uv):
    """Bilinear texture sample. tex: (Ht,Wt,3) in [0,1]; uv: (P,2) in [0,1]
    with v already flipped to image rows. Clamp addressing, texel centres at
    half-integers."""
    Ht, Wt = tex.shape[:2]
    x = uv[:, 0] * Wt - 0.5
    y = uv[:, 1] * Ht - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = (x0 + dx).clamp(0, Wt - 1).long()
            yi = (y0 + dy).clamp(0, Ht - 1).long()
            wgt = ((1 - tx) if dx == 0 else tx) * ((1 - ty) if dy == 0 else ty)
            out = out + tex[yi, xi] * wgt[:, None]
    return out


def shade(color, diffuse, use_light, w_ambient, w_diffuse):
    """Gouraud lighting (light colour = surface colour) and clip to [0,1]."""
    if use_light:
        color = color * w_ambient + diffuse[..., None] * color * w_diffuse
    return color.clamp(0.0, 1.0)


def _interp(pw, attr_v, vids):
    """sum_k pw[..., k] * attr_v[b, vids[..., k]] with k summed in order.
    pw: (B,P,3); attr_v: (B,V,C); vids: (B,P,3) -> (B,P,C)."""
    B, P = pw.shape[:2]
    C = attr_v.shape[-1]
    out = 0.0
    for k in range(3):
        idx = vids[..., k][..., None].expand(B, P, C)
        out = out + pw[..., k : k + 1] * torch.gather(attr_v, 1, idx)
    return out


def _render_chunk(mesh_tensors, poses, K, crop_tfs, H, W, use_light, with_normal,
                  w_ambient, w_diffuse, light_dir, backface_cull, face_chunk,
                  face_ok=None):
    """One chunk of poses. ``face_ok`` (B,P,F) bool, when given, limits each
    pixel to the faces it marks — how the tests render a tile from only the
    faces binned to it."""
    dev = poses.device
    B = poses.shape[0]
    P = H * W
    faces = mesh_tensors["faces"].long()
    F = faces.shape[0]
    s = face_setup(mesh_tensors, poses, K, crop_tfs, light_dir, backface_cull)
    coeff, invz, valid = s["coeff"], s["invz"], s["valid"]

    ii, jj = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([jj.reshape(-1), ii.reshape(-1), torch.ones(P, device=dev)], -1)

    best_invz = torch.full((B, P), -1.0, device=dev)
    best_tri = torch.zeros((B, P), dtype=torch.long, device=dev)
    for base in range(0, F, face_chunk):
        c = coeff[:, base : base + face_chunk]  # (B,Fc,3,3)
        Fc = c.shape[1]
        # (P,3) @ (B,3,Fc*3) -> (B,P,Fc,3) barycentrics
        w = (pix @ c.permute(0, 2, 1, 3).reshape(B, 3, Fc * 3)).reshape(B, P, Fc, 3)
        # normalised barycentrics sum to 1, so an absolute epsilon covers
        # exact-edge ties (rays through shared triangle edges)
        inside = (w >= -1e-6).all(dim=-1) & valid[:, None, base : base + Fc]
        if face_ok is not None:
            inside = inside & face_ok[:, :, base : base + Fc]
        pix_invz = (w * invz[:, None, base : base + Fc]).sum(dim=-1)
        score = torch.where(inside, pix_invz, torch.full_like(pix_invz, -1.0))
        c_best, c_idx = score.max(dim=-1)
        take = c_best > best_invz
        best_invz = torch.where(take, c_best, best_invz)
        best_tri = torch.where(take, c_idx + base, best_tri)
    hit = best_invz > 0.0

    # ---- attribute pass over the winning face only ----
    vids = faces[best_tri]  # (B,P,3)
    cw = torch.gather(
        coeff.reshape(B, F, 9), 1, best_tri[..., None].expand(B, P, 9)
    ).reshape(B, P, 3, 3)
    w = pix[None, :, 0, None] * cw[:, :, 0] + pix[None, :, 1, None] * cw[:, :, 1] + cw[:, :, 2]
    vz = torch.gather(s["v_cam"][..., 2], 1, vids.reshape(B, -1)).reshape(B, P, 3)
    pw = w / vz.clamp_min(ZNEAR)
    pw = pw / pw.sum(dim=-1, keepdim=True).clamp_min(1e-12)

    xyz = _interp(pw, s["v_cam"], vids)
    depth = xyz[..., 2]
    if "tex" in mesh_tensors:
        uvt = _interp(pw, mesh_tensors["uv"][None].expand(B, -1, -1), vids)
        color = _sample_texture(mesh_tensors["tex"], uvt.reshape(-1, 2)).reshape(B, P, 3)
    else:
        color = _interp(pw, mesh_tensors["vertex_color"][None].expand(B, -1, -1), vids)
    diff = _interp(pw, s["diff_v"][..., None], vids)[..., 0]
    color = shade(color, diff, use_light, w_ambient, w_diffuse)

    hit_f = hit[..., None].float()
    out = {
        "rgb": (color * hit_f).reshape(B, H, W, 3),
        "depth": (depth * hit).reshape(B, H, W),
        "xyz": (xyz * hit_f).reshape(B, H, W, 3),
        "mask": hit.reshape(B, H, W),
        "tri": torch.where(hit, best_tri, torch.full_like(best_tri, -1)).reshape(B, H, W),
    }
    if with_normal:
        n_pix = _interp(pw, s["n_cam"], vids)
        n_pix = n_pix / torch.linalg.norm(n_pix, dim=-1, keepdim=True).clamp_min(1e-12)
        out["normal"] = (n_pix * hit_f).reshape(B, H, W, 3)
    return out


def prepare_render_args(mesh_tensors, poses, K, crop_tfs):
    """Bring poses / K / crop tfs to float32 tensors on the mesh's device;
    ``crop_tfs=None`` means identity (full frame)."""
    dev = mesh_tensors["pos"].device
    poses = as_f32(poses, dev)
    K = as_f32(K, dev)
    if crop_tfs is None:
        crop_tfs = torch.eye(3, device=dev).expand(poses.shape[0], 3, 3)
    else:
        crop_tfs = as_f32(crop_tfs, dev)
    return poses, K, crop_tfs


def render_crops(
    mesh_tensors,
    poses,
    K,
    crop_tfs=None,
    out_hw=(160, 160),
    use_light=True,
    with_normal=True,
    w_ambient=0.8,
    w_diffuse=0.5,
    light_dir=(0.0, 0.0, 1.0),
    backface_cull=False,
    face_chunk=256,
    pose_chunk=8,
):
    """Render a batch of pose hypotheses into crop windows (plain version).

    Args:
      mesh_tensors: dict from :func:`make_mesh_tensors`.
      poses: (B,4,4) object-in-camera (OpenCV convention).
      K: (3,3) intrinsics.
      crop_tfs: (B,3,3) original-pixel -> crop-pixel transforms (from
        ``compute_crop_window_tf_batch``); None = full frame.
      out_hw: (H,W) of the output crops.

    Returns dict: rgb (B,H,W,3) in [0,1], depth (B,H,W), xyz (B,H,W,3)
    cam-space map, mask (B,H,W) bool, tri (B,H,W) winning face id (-1 =
    background), and normal (B,H,W,3) cam-space when ``with_normal``.
    """
    H, W = out_hw
    poses, K, crop_tfs = prepare_render_args(mesh_tensors, poses, K, crop_tfs)
    chunks = [
        _render_chunk(
            mesh_tensors, poses[i : i + pose_chunk], K, crop_tfs[i : i + pose_chunk],
            H, W, use_light, with_normal, w_ambient, w_diffuse, light_dir,
            backface_cull, face_chunk,
        )
        for i in range(0, poses.shape[0], pose_chunk)
    ]
    return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


def render_full_frame(mesh_tensors, poses, K, hw, **kw):
    """Full-image render: identity crop transform."""
    return render_crops(mesh_tensors, poses, K, None, out_hw=hw, **kw)
