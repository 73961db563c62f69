"""CUDA crop rasterizer: the hot-path renderer for hypothesis crops.

Replaces the Pallas TPU kernel
foundationpose_tpu/ops/raster_pallas.py::_make_raster_kernel (driven by
``render_crops_pallas``): same arguments at the Python boundary, same output
dict (``rgb, depth, xyz, mask`` and ``normal`` when asked). The kernel is
CUDA C++ for sm_90a in ``csrc/raster.cu``, built with nvcc at first use into
``_build/`` and bound through ctypes.

What bounds it on an H100: bytes, once the tests are few. A 252 x 160 x 160
call writes ~0.19 GB of float32 output once — 0.056 ms at the card's memory
rate — while testing every pixel against every face would be 1.6 G tests for
a 256-face bucket and 26 G at 4096 faces, which would make it
operation-bound by a wide margin. The design therefore spends its effort on
doing fewer tests and then writing the output exactly once: a block owns one
16x16 pixel tile of one pose and rejects each face for the whole tile by its
pixel bounding box, so a pixel only tests the faces near it (7 M tests on the
demo mesh); the survivors sit in shared memory (one broadcast read serves
all 256 threads), the running best stays in registers, and each thread
writes its pixel's final values. Winner attributes are a direct gather of
three vertices — cheap on this card — so nothing of the TPU kernel's lane
chunks, packed integer score, one-hot matmul fetch, bf16 plane tables or
y-sorted bands is carried over, and there is no face cap beyond memory.
The per-pose setup (face records, vertex tables) is plain tensor code today
and costs more than the kernel itself; ``chip_smoke.py`` prints both.

Dispatch rule: CUDA tensors go to the kernel (a build, load or launch
failure raises); CPU tensors go to the plain version in ``ops/raster.py``.
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch

from foundationpose_tpu_torch.ops import raster as plain

LAUNCHES = 0          # incremented once per kernel launch
BUILD_SECONDS = None  # wall time of the nvcc build done by this process, if any
BBOX_PAD = 0.5        # pixels; covers the -1e-6 edge epsilon and f32 rounding

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "raster.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lib = None
BUILD_LOG = ""        # compiler output of that build (ptxas register / shared memory report)


def _find_nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.exists(cand):
            return cand
    return "nvcc"  # let the PATH decide; a missing compiler raises below


def build():
    """Compile ``csrc/raster.cu`` into ``_build/`` (keyed by a hash of the
    source and flags) and load it. Raises on any failure."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libfp_raster_{key}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_find_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
            capture_output=True, text=True,
        )
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SRC}:\n{BUILD_LOG}")
        os.replace(tmp, so_path)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(so_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fp_raster_launch.argtypes = (
        [vp] * 4 + [ci] * 8 + [cf] * 2 + [vp] * 8
    )
    lib.fp_raster_launch.restype = ci
    _lib = lib
    return lib


def make_kernel_inputs(mesh_tensors, poses, K, crop_tfs, light_dir=(0.0, 0.0, 1.0),
                       backface_cull=False):
    """Per-pose face records and vertex tables the kernel reads (layout in
    ``csrc/raster.cu``), from the same ``face_setup`` arithmetic as the plain
    version. Plain tensor code, so the CPU tests reach it."""
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
    V = s["v_cam"].shape[1]
    vtab = torch.cat(
        [s["v_cam"], s["n_cam"], s["diff_v"][..., None], torch.zeros_like(s["diff_v"][..., None])],
        dim=-1,
    ).contiguous()  # (B,V,8)
    if "tex" in mesh_tensors:
        col = torch.cat([mesh_tensors["uv"], torch.zeros_like(mesh_tensors["uv"])], dim=-1)
    else:
        vc = mesh_tensors["vertex_color"]
        col = torch.cat([vc, torch.zeros_like(vc[:, :1])], dim=-1)
    return {"rec": rec, "vtab": vtab, "vcol": col.contiguous(),
            "faces": mesh_tensors["faces"].contiguous(), "V": V}


def tile_face_tests(rec, H, W, tile=16):
    """Number of pixel x face tests a launch makes after tile rejection
    (each surviving (tile, face) pair costs tile*tile tests). Used to compute
    the kernel's operation bound from the inputs of a run."""
    bb = rec[..., 12:16]
    tx0 = torch.arange(0, W, tile, device=rec.device, dtype=torch.float32)
    ty0 = torch.arange(0, H, tile, device=rec.device, dtype=torch.float32)
    ox = (bb[..., None, 1] >= tx0) & (bb[..., None, 0] <= tx0 + tile - 1)  # (B,F,Tx)
    oy = (bb[..., None, 3] >= ty0) & (bb[..., None, 2] <= ty0 + tile - 1)  # (B,F,Ty)
    pairs = (ox.sum(dim=-1).double() * oy.sum(dim=-1).double()).sum()
    return int(pairs.item()) * tile * tile


def _launch(inp, B, H, W, textured, use_light, with_normal, w_ambient, w_diffuse,
            with_tri=False):
    global LAUNCHES
    lib = build()
    dev = inp["rec"].device
    for name, dt in (("rec", torch.float32), ("vtab", torch.float32),
                     ("vcol", torch.float32), ("faces", torch.int32)):
        x = inp[name]
        if not (x.is_cuda and x.dtype == dt and x.is_contiguous() and x.device == dev):
            raise ValueError(f"raster kernel input {name}: needs a contiguous "
                             f"{dt} CUDA tensor on {dev}, got {x.dtype} on {x.device}")
    F = inp["rec"].shape[1]
    if B < 1 or B > 65535:
        raise ValueError(f"raster kernel takes 1..65535 poses per launch, got {B}")
    f32 = dict(dtype=torch.float32, device=dev)
    rgb = torch.empty((B, H, W, 3), **f32)
    xyz = torch.empty((B, H, W, 3), **f32)
    depth = torch.empty((B, H, W), **f32)
    mask = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    normal = torch.empty((B, H, W, 3), **f32) if with_normal else None
    diffuse = torch.empty((B, H, W), **f32) if textured else None
    tri = torch.empty((B, H, W), dtype=torch.int32, device=dev) if with_tri else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fp_raster_launch(
            inp["rec"].data_ptr(), inp["vtab"].data_ptr(), inp["vcol"].data_ptr(),
            inp["faces"].data_ptr(), B, F, inp["V"], H, W,
            int(textured), int(use_light), int(with_normal),
            float(w_ambient), float(w_diffuse),
            rgb.data_ptr(), xyz.data_ptr(), depth.data_ptr(), mask.data_ptr(),
            normal.data_ptr() if with_normal else None,
            diffuse.data_ptr() if textured else None,
            tri.data_ptr() if with_tri else None,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return rgb, xyz, depth, mask, normal, diffuse, tri


def render_crops_cuda(mesh_tensors, poses, K, crop_tfs, out_hw, use_light,
                      w_ambient, w_diffuse, light_dir, backface_cull, with_normal,
                      with_tri=False):
    """Setup (tensor ops) -> kernel -> epilogue (texture sampling only).
    ``with_tri`` adds the winning face ids (``tri``, -1 = background) — what
    the plain version also reports; used to compare the two winner by winner."""
    H, W = out_hw
    B = poses.shape[0]
    textured = "tex" in mesh_tensors
    inp = make_kernel_inputs(mesh_tensors, poses, K, crop_tfs, light_dir, backface_cull)
    rgb, xyz, depth, mask, normal, diffuse, tri = _launch(
        inp, B, H, W, textured, use_light, with_normal, w_ambient, w_diffuse, with_tri
    )
    mask = mask.bool()
    if textured:
        color = plain._sample_texture(
            mesh_tensors["tex"], rgb[..., :2].reshape(-1, 2)
        ).reshape(B, H, W, 3)
        rgb = plain.shade(color, diffuse, use_light, w_ambient, w_diffuse) * mask[..., None]
    out = {"rgb": rgb, "depth": depth, "xyz": xyz, "mask": mask}
    if with_normal:
        out["normal"] = normal
    if with_tri:
        out["tri"] = tri.long()
    return out


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
):
    """Render B poses of one mesh into their crop windows.

    Same contract as ``render_crops_pallas`` of the JAX package: returns
    ``rgb`` (B,H,W,3) lit colour in [0,1], ``depth`` (B,H,W), ``xyz``
    (B,H,W,3) camera-space, ``mask`` (B,H,W) bool and, when ``with_normal``,
    ``normal`` (B,H,W,3). Tensors on a CUDA device run the kernel; tensors on
    the CPU run the plain version.
    """
    poses, K, crop_tfs = plain.prepare_render_args(mesh_tensors, poses, K, crop_tfs)
    if poses.is_cuda:
        return render_crops_cuda(
            mesh_tensors, poses, K, crop_tfs, tuple(out_hw), use_light,
            w_ambient, w_diffuse, light_dir, backface_cull, with_normal,
        )
    out = plain.render_crops(
        mesh_tensors, poses, K, crop_tfs, out_hw=tuple(out_hw), use_light=use_light,
        with_normal=with_normal, w_ambient=w_ambient, w_diffuse=w_diffuse,
        light_dir=light_dir, backface_cull=backface_cull,
    )
    out.pop("tri")
    return out


def render_full_frame(mesh_tensors, poses, K, hw, **kw):
    """Full-image render: identity crop transform."""
    return render_crops(mesh_tensors, poses, K, None, out_hw=hw, **kw)
