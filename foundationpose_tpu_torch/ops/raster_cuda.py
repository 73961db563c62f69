"""CUDA crop rasterizer: the hot-path renderer for hypothesis crops.

Replaces the Pallas TPU kernel
foundationpose_tpu/ops/raster_pallas.py::_make_raster_kernel (driven by
``render_crops_pallas``): same arguments at the Python boundary, same output
dict (``rgb, depth, xyz, mask`` and ``normal`` when asked). On CUDA tensors
one call is: allocate outputs and scratch -> setup kernel -> raster kernel.
Both kernels are CUDA C++ for sm_90a under ``csrc/``, built with nvcc at
first use into ``_build/`` (one compiler process per source, started
together) and bound through ctypes:

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
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches, per kernel, and nothing else; ``launched_libraries()`` names the
library files whose code those launches called, as the dynamic loader
resolves the launch functions' addresses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from foundationpose_tpu_torch.ops import raster as plain
from foundationpose_tpu_torch.utils.profiling import span

LAUNCHES = {"K1s": 0, "K1r": 0}  # one more per launch of that kernel
_SPANS = {"K1s": "raster.K1s", "K1r": "raster.K1r"}  # the launch call's span
BUILD_LOG = {}        # kernel -> compiler output (ptxas register / shared memory report)
BBOX_PAD = 0.5        # pixels; covers the -1e-6 edge epsilon and f32 rounding
TILE = 16             # pixels; a block of K1r owns one TILE x TILE tile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# every card library of the port: kernel -> (source, extra flags). K1s and
# K2 round a*b+c twice, as the eager tensor ops of their plain versions do
# (see the notes in their sources). K2 is bound by ``ops/depth_cuda.py``.
LIBRARIES = {
    "K1s": (os.path.join(_PKG_DIR, "csrc", "raster_setup.cu"), ["-fmad=false"]),
    "K1r": (os.path.join(_PKG_DIR, "csrc", "raster.cu"), []),
    "K2": (os.path.join(_PKG_DIR, "csrc", "depth_preprocess.cu"), ["-fmad=false"]),
}
SOURCES = {k: LIBRARIES[k] for k in ("K1s", "K1r")}  # the kernels every render call launches
_paths = None
_libs = None
_LAUNCHED_FNS = {"K1s": {}, "K1r": {}}  # kernel -> {id: launch function called}


def _find_nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.exists(cand):
            return cand
    return "nvcc"  # let the PATH decide; a missing compiler raises below


def library_path(name, src, flags):
    """Where ``_build/`` keeps the library of ``src`` built with ``flags``:
    named after a hash of the source and the flags."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libfp_{name.lower()}_{key}.so")


def _start_build(name, src, flags):
    """Start nvcc on ``src`` unless ``_build/`` already holds the library.
    Returns (library path, temporary path, process or None)."""
    so_path = library_path(name, src, flags)
    if os.path.exists(so_path):
        return so_path, None, None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_find_nvcc(), *flags, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so_path, tmp, proc


def compile_libraries(specs, log):
    """Build ``specs`` ({name: (source, nvcc flags)}), the compilers running
    side by side; each one's output goes to ``log[name]``. Returns {name:
    library path}. Raises naming every source that failed."""
    jobs = {name: _start_build(name, src, flags) for name, (src, flags) in specs.items()}
    failed = []
    for name, (so_path, tmp, proc) in jobs.items():
        if proc is None:
            continue
        log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {specs[name][0]}:\n{log[name]}")
        else:
            os.replace(tmp, so_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: job[0] for name, job in jobs.items()}


def bind_setup(path):
    """The typed launch function of a built K1s library."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ctypes.CDLL(path).fp_raster_setup_launch
    fn.argtypes = [vp] * 6 + [ci] * 6 + [cf] * 3 + [vp] * 4
    fn.restype = ci
    return fn


def bind_raster(path):
    """The typed launch function of a built K1r library."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ctypes.CDLL(path).fp_raster_launch
    fn.argtypes = [vp] * 6 + [ci] * 9 + [cf] * 2 + [vp] * 8
    fn.restype = ci
    return fn


def spec(name):
    """(source, nvcc flags) of the card library ``name`` of ``LIBRARIES``."""
    src, extra = LIBRARIES[name]
    return src, _NVCC_FLAGS + extra


def default_specs():
    """{kernel: (source, nvcc flags)} of the kernels every render call
    launches: no part switch defined."""
    return {name: spec(name) for name in SOURCES}


def library_paths():
    """Build every library of ``LIBRARIES`` into ``_build/`` once per
    process, the compilers running side by side, so a checkout's first call
    pays one build. Returns {kernel: library path}. Raises on any failure."""
    global _paths
    if _paths is None:
        _paths = compile_libraries({name: spec(name) for name in LIBRARIES}, BUILD_LOG)
    return _paths


def build():
    """Build (``library_paths``) and load K1s and K1r. Raises on any failure."""
    global _libs
    if _libs is None:
        paths = library_paths()
        _libs = {"K1s": bind_setup(paths["K1s"]), "K1r": bind_raster(paths["K1r"])}
    return _libs


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


def _launch(name, dev, *args):
    fn = build()[name]
    with torch.cuda.device(dev), span(_SPANS[name]):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    _LAUNCHED_FNS[name][id(fn)] = fn  # ctypes functions do not hash


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def library_file(fn):
    """The file of the shared library that holds the code of the ctypes
    function ``fn``, as the dynamic loader resolves its address
    (``dladdr``), with links resolved."""
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    info = _DlInfo()
    if not dladdr(ctypes.cast(fn, ctypes.c_void_p), ctypes.byref(info)) or not info.dli_fname:
        raise RuntimeError(f"the dynamic loader places {fn} in no library")
    return os.path.realpath(info.dli_fname.decode())


def launched_libraries():
    """{kernel: set of library files} that this process's kernel launches
    called into, since it started."""
    return {name: {library_file(fn) for fn in fns.values()}
            for name, fns in _LAUNCHED_FNS.items()}


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
    _launch("K1s", dev, *args)
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
    _launch("K1r", dev, *args)
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
