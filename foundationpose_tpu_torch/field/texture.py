"""Texture baking: project training images onto the reconstructed mesh.

Counterpart of foundationpose_tpu/field/texture.py (``unwrap_triangle_atlas``,
``bake_texture``, ``nearest_fill``), after the reference's
``mesh_texture_from_train_images`` (bundlesdf/nerf_runner.py:1122-1232):

1. UV atlas: triangle pairs packed into square cells of a regular grid
   (vertices split per face, so uvs are face-varying); vectorised here, the
   same float64 arithmetic as the JAX package's per-face loop.
2. Visibility: every view rendered through ``ops/raster_cuda.render_full_frame``
   with ``tri`` + ``bary`` — K1s + K1r on the card, the plain rasterizer on
   the CPU — unlit and unculled, views batched into calls whose tile bins stay
   under ``BINS_BUDGET`` bytes. Each hit pixel yields its face and
   perspective-correct barycentrics directly.
3. Blending: ``color * cos(incidence)^4`` accumulated into the atlas in
   float64 on the host (``np.add.at``), normalised, empty texels filled from
   the nearest observed one (scipy ``distance_transform_edt``).
"""

from __future__ import annotations

import logging
import math

import numpy as np

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core.meshio import Mesh, compute_face_normals
from foundationpose_tpu_torch.ops import raster, raster_cuda

BINS_BUDGET = 32 * 2**20  # bytes of K1s scratch (bit table + face records) per render call


def unwrap_triangle_atlas(mesh: Mesh, tex_res=1024, inset=1.5):
    """Split vertices per-face and assign each triangle a half-cell of a
    regular grid atlas. Returns a new Mesh with per-vertex uv in [0,1]."""
    F = len(mesh.faces)
    cells = (F + 1) // 2
    grid = int(math.ceil(math.sqrt(cells)))
    cell = tex_res / grid

    verts = mesh.vertices[mesh.faces].reshape(-1, 3)  # (F*3,3)
    faces = np.arange(F * 3, dtype=np.int32).reshape(-1, 3)
    f = np.arange(F)
    c = f // 2
    x0 = (c % grid) * cell
    y0 = (c // grid) * cell
    lower = [  # lower-left triangle of the cell (even faces)
        (x0 + inset, y0 + inset),
        (x0 + cell - 2 * inset, y0 + inset),
        (x0 + inset, y0 + cell - 2 * inset),
    ]
    upper = [  # upper-right (odd faces)
        (x0 + cell - inset, y0 + cell - inset),
        (x0 + 2 * inset, y0 + cell - inset),
        (x0 + cell - inset, y0 + 2 * inset),
    ]
    even = (f % 2 == 0)[:, None]
    corners = np.stack(
        [np.where(even, np.stack(lo, -1), np.stack(up, -1)) for lo, up in zip(lower, upper)],
        axis=1,
    )  # (F,3,2)
    uv = corners.reshape(-1, 2) / tex_res
    out = Mesh(verts, faces)
    # uv here is in image coords with v increasing downward (texture ROW) —
    # store flipped so Mesh.uv keeps the OBJ bottom-left convention
    out.uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=-1)
    return out


def _views_per_call(n_faces, hw, bins_budget):
    """Views per render call so that the per-call tile bit table and face
    records (K1s's scratch) stay under ``bins_budget`` bytes."""
    tiles = -(-hw[0] // raster_cuda.TILE) * -(-hw[1] // raster_cuda.TILE)
    per_view = tiles * ((n_faces + 31) // 32) * 4 + n_faces * 64
    return max(1, int(bins_budget // max(per_view, 1)))


def bake_texture(mesh: Mesh, images, masks, cam_in_obs, K, tex_res=1024,
                 cos_power=4.0, min_cos=0.2, device=None):
    """Bake ``images`` (N,H,W,3 in [0,1] or [0,255]) seen from ``cam_in_obs``
    (N,4,4) onto ``mesh`` (object frame). Returns a new unwrapped Mesh with
    ``texture`` filled. Renders on ``device`` (None = cuda). The JAX
    package's unused ``depth_tol`` argument is not carried over."""
    images = np.asarray(images, dtype=np.float64)
    if images.max() <= 1.0 + 1e-6:
        images = images * 255.0
    H, W = images.shape[1:3]
    un = unwrap_triangle_atlas(mesh, tex_res=tex_res)
    mt = raster.make_mesh_tensors(un, device=resolve_device(device))
    # face-corner uv in texture-image ROW coords
    uv_img = np.stack([un.uv[:, 0], 1.0 - un.uv[:, 1]], axis=-1) * tex_res
    face_uv = uv_img[un.faces]  # (F,3,2)
    fnormals = compute_face_normals(un.vertices, un.faces)
    fnormals = fnormals / np.maximum(np.linalg.norm(fnormals, axis=-1, keepdims=True), 1e-12)

    acc = np.zeros((tex_res, tex_res, 3))
    wacc = np.zeros((tex_res, tex_res))

    ob_in_cams = np.linalg.inv(np.asarray(cam_in_obs, dtype=np.float64))
    step = _views_per_call(len(un.faces), (H, W), BINS_BUDGET)
    for s in range(0, len(images), step):
        out = raster_cuda.render_full_frame(
            mt, ob_in_cams[s:s + step].astype(np.float32), K, (H, W), use_light=False,
            with_normal=False, with_tri=True, with_bary=True)
        out = {k: out[k].cpu().numpy() for k in ("tri", "bary", "mask", "xyz")}
        for j in range(out["tri"].shape[0]):
            i = s + j
            ob_in_cam = ob_in_cams[i]
            valid = out["mask"][j] & (np.asarray(masks[i]) > 0)
            vs, us = np.nonzero(valid)
            if len(vs) == 0:
                continue
            t = out["tri"][j][vs, us]
            b = out["bary"][j][vs, us]  # (P,3)
            uv = np.einsum("pk,pkj->pj", b, face_uv[t])  # (P,2) texture coords
            # incidence weighting: normal vs ray direction in cam frame
            n_cam = fnormals[t] @ ob_in_cam[:3, :3].T
            xyz = out["xyz"][j][vs, us]
            ray = xyz / np.maximum(np.linalg.norm(xyz, axis=-1, keepdims=True), 1e-12)
            cosv = np.clip((n_cam * -ray).sum(-1), 0.0, 1.0)
            w = np.where(cosv > min_cos, cosv**cos_power, 0.0)
            colors = images[i][vs, us]

            xi = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, tex_res - 1)
            yi = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, tex_res - 1)
            np.add.at(acc, (yi, xi), colors * w[:, None])
            np.add.at(wacc, (yi, xi), w)

    filled = wacc > 1e-8
    tex = np.zeros((tex_res, tex_res, 3), np.float64)
    tex[filled] = acc[filled] / wacc[filled][:, None]
    tex = nearest_fill(tex, filled)
    un.texture = np.clip(tex, 0, 255).astype(np.uint8)
    logging.info("baked texture: %.1f%% texels observed", 100.0 * filled.mean())
    return un


def nearest_fill(tex, filled):
    """Fill unobserved texels from the nearest observed one (replaces the
    reference's scipy griddata nearest interpolation, Utils.py:886-900)."""
    if filled.all() or not filled.any():
        return tex
    from scipy import ndimage

    idx = ndimage.distance_transform_edt(~filled, return_distances=False, return_indices=True)
    return tex[idx[0], idx[1]]
