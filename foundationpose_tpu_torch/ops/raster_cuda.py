"""CUDA crop rasterizer: the hot-path renderer for hypothesis crops.

Replaces the Pallas TPU kernel
foundationpose_tpu/ops/raster_pallas.py::_make_raster_kernel (driven by
``render_crops_pallas``): same arguments at the Python boundary, same output
dict (``rgb, depth, xyz, mask`` and ``normal`` when asked). On CUDA tensors
one call is: allocate outputs and scratch -> setup kernel -> raster kernel.
Both kernels are CUDA C++ for sm_90a under ``csrc/``, built, loaded,
launched and counted by ``ops/kernels.py``:

- **K1s** (``csrc/raster_setup.cu``): per-(pose, vertex) table, per-(pose,
  face) records and a per-(pose, tile) bit table of the faces whose bounding
  box touches the tile. Counterpart of the XLA prep around the TPU kernel;
  its plain version is ``face_setup`` + ``make_kernel_inputs`` + ``tile_bins``.
- **K1r** (``csrc/raster.cu``): a block owns one 16x16 pixel tile of one pose,
  reads its row of the bit table and only those faces' records, finds each
  pixel's winner and writes the final values, texture sampling and lighting
  included. Its plain version is ``ops/raster.py::render_crops``.

What bounds the call on an H100: bytes. A 252 x 160 x 160 call writes
~0.19 GB of float32 output once — 0.056 ms at the card's memory rate — while
the pixel x face tests left after binning are worth 0.003-0.04 ms of float32
work. So the design does few tests and writes the output exactly once; no
tensor op touches per-face or per-pixel data between the arguments and the
result. Nothing of the TPU kernel's lane chunks, packed integer score,
one-hot matmul fetch, bf16 plane tables or y-sorted bands is carried over,
and there is no face cap beyond memory.

Dispatch rule: CUDA tensors go to the kernels (a build, load or launch
failure raises); CPU tensors go to the plain version in ``ops/raster.py``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationpose_tpu_torch.ops import kernels
from foundationpose_tpu_torch.ops import raster as plain

# every card kernel's launch span, by kernel (benchmark/tests reads it here)
_SPANS = {name: lib.span for name, lib in kernels.LIBRARIES.items()}
BBOX_PAD = 0.5        # pixels; covers the -1e-6 edge epsilon and f32 rounding
TILE = 16             # pixels; a block of K1r owns one TILE x TILE tile


def make_kernel_inputs(mesh_tensors, poses, K, crop_tfs, light_dir=(0.0, 0.0, 1.0),
                       backface_cull=False):
    """Plain version of K1s's tables: per-pose face records ``rec`` (B,F,16)
    and vertex table ``vtab`` (B,V,8) (layouts in ``csrc/raster_setup.cu``),
    from the same ``face_setup`` arithmetic as the plain rasterizer. Plain
    tensor code, so the CPU tests reach it."""
    s = plain.face_setup(mesh_tensors, poses, K, crop_tfs, light_dir, backface_cull)
    B, F = s["valid"].shape
    xy = s["tri_xy"]
    big = torch.full_like(xy[..., 0, 0], 1e30)
    xmin = torch.where(s["valid"], xy[..., 0].amin(dim=-1) - BBOX_PAD, big)
    xmax = torch.where(s["valid"], xy[..., 0].amax(dim=-1) + BBOX_PAD, -big)
    ymin = torch.where(s["valid"], xy[..., 1].amin(dim=-1) - BBOX_PAD, big)
    ymax = torch.where(s["valid"], xy[..., 1].amax(dim=-1) + BBOX_PAD, -big)
    # coeff[b,f,row,k]: rows px/py/1 -> per corner k the triple (a_k,b_k,c_k)
    abc = s["coeff"].transpose(2, 3).reshape(B, F, 9)
    rec = torch.cat(
        [abc, s["invz"], torch.stack([xmin, xmax, ymin, ymax], dim=-1)], dim=-1
    ).contiguous()  # (B,F,16)
    vtab = torch.cat(
        [s["v_cam"], s["n_cam"], s["diff_v"][..., None], torch.zeros_like(s["diff_v"][..., None])],
        dim=-1,
    ).contiguous()  # (B,V,8)
    return {"rec": rec, "vtab": vtab, "faces": mesh_tensors["faces"].contiguous()}


def _tile_overlaps(rec, H, W, tile):
    """Per face, which tile columns (B,F,Tx) and tile rows (B,F,Ty) its padded
    bounding box touches; a face is binned to a tile when both hold."""
    bb = rec[..., 12:16]
    tx0 = torch.arange(0, W, tile, device=rec.device, dtype=torch.float32)
    ty0 = torch.arange(0, H, tile, device=rec.device, dtype=torch.float32)
    ox = (bb[..., None, 1] >= tx0) & (bb[..., None, 0] <= tx0 + tile - 1)
    oy = (bb[..., None, 3] >= ty0) & (bb[..., None, 2] <= ty0 + tile - 1)
    return ox, oy


def tile_face_tests(rec, H, W, tile=TILE):
    """Number of pixel x face tests a launch makes after tile rejection
    (each surviving (tile, face) pair costs tile*tile tests). Used to compute
    the call's operation bound from the inputs of a run."""
    ox, oy = _tile_overlaps(rec, H, W, tile)
    pairs = (ox.sum(dim=-1).double() * oy.sum(dim=-1).double()).sum()
    return int(pairs.item()) * tile * tile


def tile_bins(rec, H, W, tile=TILE):
    """Plain version of K1s's binning: the bit table (B, tiles, ceil(F/32))
    int32 in which bit ``f % 32`` of word ``f // 32`` says that face ``f``'s
    padded bounding box touches the tile (tiles in row-major order). Faces
    with an empty box are in no tile."""
    B, F = rec.shape[:2]
    ox, oy = _tile_overlaps(rec, H, W, tile)
    ov = oy.transpose(1, 2)[:, :, None] & ox.transpose(1, 2)[:, None]  # (B,Ty,Tx,F)
    words = (F + 31) // 32
    ov = torch.nn.functional.pad(ov.reshape(B, -1, F), (0, words * 32 - F))
    # pack 8 faces into a byte, 4 bytes into a little-endian word
    weights = 2 ** torch.arange(8, device=rec.device)
    packed = (ov.reshape(B, -1, words, 4, 8) * weights).sum(dim=-1).to(torch.uint8)
    return packed.contiguous().view(torch.int32).reshape(B, -1, words)


def unpack_bins(bins, F):
    """(B, tiles, words) bit table -> (B, tiles, F) bool."""
    bit = (bins[..., None] >> torch.arange(32, device=bins.device, dtype=torch.int32)) & 1
    return bit.reshape(*bins.shape[:2], -1)[..., :F].bool()


def _check(name, x, dtype, shape):
    if not (isinstance(x, torch.Tensor) and x.is_cuda and x.dtype == dtype
            and x.is_contiguous() and tuple(x.shape) == tuple(shape)):
        got = f"{tuple(x.shape)} {x.dtype} on {x.device}" if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"raster kernels: {name} must be a contiguous {dtype} CUDA "
                         f"tensor of shape {tuple(shape)}, got {got}")
    return x


def setup_launch_args(mesh_tensors, poses, K, crop_tfs, out_hw, light_dir=(0.0, 0.0, 1.0),
                      backface_cull=False):
    """Checked arguments of one K1s launch. Returns (device, the launch
    function's arguments before the stream, the scratch it fills)."""
    H, W = out_hw
    B = poses.shape[0]
    V, F = mesh_tensors["pos"].shape[0], mesh_tensors["faces"].shape[0]
    if not 1 <= B <= 65535:
        raise ValueError(f"raster kernels take 1..65535 poses per call, got {B}")
    pos = _check("pos", mesh_tensors["pos"], torch.float32, (V, 3))
    dev = pos.device
    vnormals = _check("vnormals", mesh_tensors["vnormals"], torch.float32, (V, 3))
    faces = _check("faces", mesh_tensors["faces"], torch.int32, (F, 3))
    poses = _check("poses", poses.contiguous(), torch.float32, (B, 4, 4))
    K = _check("K", K.contiguous(), torch.float32, (3, 3))
    crop_tfs = _check("crop_tfs", crop_tfs.contiguous(), torch.float32, (B, 3, 3))
    if len({x.device for x in (pos, vnormals, faces, poses, K, crop_tfs)}) != 1:
        raise ValueError("raster kernels: all inputs must lie on one device")
    light = np.asarray(light_dir, np.float32)
    light = light / max(np.linalg.norm(light), np.float32(1e-12))
    tiles = -(-H // TILE) * -(-W // TILE)
    vtab = torch.empty((B, V, 8), dtype=torch.float32, device=dev)
    rec = torch.empty((B, F, 16), dtype=torch.float32, device=dev)
    bins = torch.empty((B, tiles, (F + 31) // 32), dtype=torch.int32, device=dev)
    args = (pos.data_ptr(), vnormals.data_ptr(), faces.data_ptr(),
            poses.data_ptr(), K.data_ptr(), crop_tfs.data_ptr(), B, V, F, H, W,
            int(bool(backface_cull)), float(light[0]), float(light[1]), float(light[2]),
            vtab.data_ptr(), rec.data_ptr(), bins.data_ptr())
    return dev, args, {"vtab": vtab, "rec": rec, "bins": bins}


def setup_cuda(mesh_tensors, poses, K, crop_tfs, out_hw, light_dir=(0.0, 0.0, 1.0),
               backface_cull=False):
    """Launch K1s. Returns the scratch the rasterizer reads: ``vtab``
    (B,V,8), ``rec`` (B,F,16; an invalid face holds only its empty bounding
    box) and ``bins`` (B,tiles,ceil(F/32)) int32."""
    dev, args, scratch = setup_launch_args(mesh_tensors, poses, K, crop_tfs, out_hw,
                                           light_dir, backface_cull)
    kernels.launch("K1s", dev, *args)
    return scratch


def raster_launch_args(mesh_tensors, scratch, out_hw, use_light, w_ambient, w_diffuse,
                       with_normal, with_tri=False, with_bary=False):
    """Checked arguments of one K1r launch on the scratch of
    :func:`setup_cuda`. Returns (device, the launch function's arguments
    before the stream, the output dict it fills)."""
    H, W = out_hw
    B, V = scratch["vtab"].shape[:2]
    F = mesh_tensors["faces"].shape[0]
    tiles = -(-H // TILE) * -(-W // TILE)
    faces = _check("faces", mesh_tensors["faces"], torch.int32, (F, 3))
    dev = faces.device
    _check("vtab", scratch["vtab"], torch.float32, (B, V, 8))
    _check("rec", scratch["rec"], torch.float32, (B, F, 16))
    _check("bins", scratch["bins"], torch.int32, (B, tiles, (F + 31) // 32))
    if "tex" in mesh_tensors:
        Ht, Wt = mesh_tensors["tex"].shape[:2]
        tex = _check("tex", mesh_tensors["tex"], torch.float32, (Ht, Wt, 3))
        vcol = _check("uv", mesh_tensors["uv"], torch.float32, (V, 2))
    else:
        Ht = Wt = 0
        tex = None
        vcol = _check("vertex_color", mesh_tensors["vertex_color"], torch.float32, (V, 3))
    if any(x is not None and x.device != dev for x in (tex, vcol, *scratch.values())):
        raise ValueError("raster kernels: all inputs must lie on one device")
    f32 = dict(dtype=torch.float32, device=dev)
    out = {
        "rgb": torch.empty((B, H, W, 3), **f32),
        "depth": torch.empty((B, H, W), **f32),
        "xyz": torch.empty((B, H, W, 3), **f32),
        "mask": torch.empty((B, H, W), dtype=torch.bool, device=dev),  # the kernel writes 0/1
    }
    if with_normal:
        out["normal"] = torch.empty((B, H, W, 3), **f32)
    if with_tri:
        out["tri"] = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    if with_bary:
        out["bary"] = torch.empty((B, H, W, 3), **f32)
    args = (scratch["rec"].data_ptr(), scratch["bins"].data_ptr(),
            scratch["vtab"].data_ptr(), faces.data_ptr(), vcol.data_ptr(),
            tex.data_ptr() if tex is not None else None,
            B, F, V, H, W, Ht, Wt, int(bool(use_light)), int(bool(with_normal)),
            float(w_ambient), float(w_diffuse),
            out["rgb"].data_ptr(), out["xyz"].data_ptr(), out["depth"].data_ptr(),
            out["mask"].data_ptr(), out["normal"].data_ptr() if with_normal else None,
            out["tri"].data_ptr() if with_tri else None,
            out["bary"].data_ptr() if with_bary else None)
    return dev, args, out


def rasterize_cuda(mesh_tensors, scratch, out_hw, use_light, w_ambient, w_diffuse,
                   with_normal, with_tri=False, with_bary=False):
    """Launch K1r on the scratch of :func:`setup_cuda`. Returns the output
    dict of ``render_crops`` (plus ``tri`` int32 and ``bary`` when asked)."""
    dev, args, out = raster_launch_args(mesh_tensors, scratch, out_hw, use_light, w_ambient,
                                        w_diffuse, with_normal, with_tri, with_bary)
    kernels.launch("K1r", dev, *args)
    return out


def render_crops_cuda(mesh_tensors, poses, K, crop_tfs, out_hw, use_light,
                      w_ambient, w_diffuse, light_dir, backface_cull, with_normal,
                      with_tri=False, with_bary=False):
    """Allocate -> K1s -> K1r. ``with_tri`` adds the winning face ids
    (``tri``, -1 = background), ``with_bary`` their perspective-correct
    barycentrics (``bary``, 0 on background)."""
    scratch = setup_cuda(mesh_tensors, poses, K, crop_tfs, out_hw, light_dir, backface_cull)
    return rasterize_cuda(mesh_tensors, scratch, out_hw, use_light, w_ambient, w_diffuse,
                          with_normal, with_tri, with_bary)


def render_crops(
    mesh_tensors,
    poses,
    K,
    crop_tfs=None,
    out_hw=(160, 160),
    use_light=True,
    w_ambient=0.8,
    w_diffuse=0.5,
    light_dir=(0.0, 0.0, 1.0),
    backface_cull=False,
    with_normal=True,
    with_tri=False,
    with_bary=False,
):
    """Render B poses of one mesh into their crop windows.

    Same contract as ``render_crops_pallas`` of the JAX package: returns
    ``rgb`` (B,H,W,3) lit colour in [0,1], ``depth`` (B,H,W), ``xyz``
    (B,H,W,3) camera-space, ``mask`` (B,H,W) bool and, when ``with_normal``,
    ``normal`` (B,H,W,3). ``with_tri`` adds ``tri`` (B,H,W) int32, the
    winning face (-1 = background), and ``with_bary`` adds ``bary``
    (B,H,W,3), its perspective-correct barycentrics (0 on background) — what
    the JAX package's plain ``render_crops`` returns for texture baking. Both
    are off by default, so no other path writes more than before. Tensors on
    a CUDA device run the kernel; tensors on the CPU run the plain version.
    """
    poses, K, crop_tfs = plain.prepare_render_args(mesh_tensors, poses, K, crop_tfs)
    if poses.is_cuda:
        return render_crops_cuda(
            mesh_tensors, poses, K, crop_tfs, tuple(out_hw), use_light,
            w_ambient, w_diffuse, light_dir, backface_cull, with_normal, with_tri, with_bary,
        )
    out = plain.render_crops(
        mesh_tensors, poses, K, crop_tfs, out_hw=tuple(out_hw), use_light=use_light,
        with_normal=with_normal, w_ambient=w_ambient, w_diffuse=w_diffuse,
        light_dir=light_dir, backface_cull=backface_cull, with_bary=with_bary,
    )
    tri = out.pop("tri")
    if with_tri:
        out["tri"] = tri.int()
    return out


def render_full_frame(mesh_tensors, poses, K, hw, **kw):
    """Full-image render: identity crop transform."""
    return render_crops(mesh_tensors, poses, K, None, out_hw=hw, **kw)
