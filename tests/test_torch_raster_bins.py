"""What the two CUDA rasterizer kernels rest on, as far as a CPU reaches it.

The kernels (``csrc/raster_setup.cu``: face records + tile bins,
``csrc/raster.cu``: rasterizer over a tile's binned faces with the texture
sampled in the kernel) run only on a card. Here their plain versions are
held to the properties the design depends on:

- ``tile_bins``: rendering every 16x16 tile from only the faces in its bins
  gives the plain render EXACTLY (mask, winning face, every value) on random
  triangle soups with slivers, degenerate faces, faces behind the camera,
  culled faces and bucket padding — no winner can be lost to binning;
- the bit layout of the table (face f is bit f % 32 of word f // 32, tiles in
  row-major order), which the kernels share with the plain version;
- the texture + lighting arithmetic written tap by tap in the kernel's order
  equals ``_sample_texture`` + ``shade``;
- the launch path (``ops/kernels.py``) counts launches per kernel, the
  wrapper never gives way to the plain version on its own, and the library
  file each launch called into is named by the launch function's address.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.ops import depth_cuda, kernels, raster, raster_cuda

torch.set_num_threads(1)
K = np.array([[200.0, 0, 24], [0, 200.0, 20], [0, 0, 1]])
HW = (40, 48)  # 3 x 3 tiles, the last row and column ragged
OPTS = dict(use_light=True, with_normal=True, w_ambient=0.8, w_diffuse=0.5,
            light_dir=(0.0, 0.0, 1.0), face_chunk=256)


def _soup(rng, n_faces, n_pad):
    """Random triangles around z = 0.5 m: ordinary ones, slivers (two corners
    a hair apart), exactly degenerate ones, some behind the camera, plus two
    large opposite-wound ones at the back so that something is always hit,
    then ``n_pad`` bucket-padding faces [0, 0, 0]."""
    tri = rng.uniform([-0.06, -0.06, 0.45], [0.06, 0.06, 0.55], (n_faces, 3, 3))
    kind = rng.integers(0, 6, n_faces)
    tri[kind == 1, 1] = tri[kind == 1, 0] + rng.normal(0, 1e-5, ((kind == 1).sum(), 3))
    tri[kind == 2, 2] = tri[kind == 2, 0]
    tri[kind == 3, :, 2] -= rng.uniform(0.5, 1.0)
    back = np.array([[-0.1, -0.1, 0.6], [0.1, -0.1, 0.6], [0.0, 0.12, 0.6]])
    tri = np.concatenate([tri, back[None], back[None, ::-1]])
    verts = tri.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    faces = np.concatenate([faces, np.zeros((n_pad, 3), faces.dtype)])
    normals = rng.normal(size=verts.shape)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    f32 = torch.float32
    return {
        "pos": torch.tensor(verts, dtype=f32), "faces": torch.tensor(faces, dtype=torch.int32),
        "vnormals": torch.tensor(normals, dtype=f32),
        "vertex_color": torch.tensor(rng.uniform(0, 1, verts.shape), dtype=f32),
    }


def _poses(rng, n):
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.01, (n, 3))
    return poses


def _face_ok_from_bins(bins, F, hw, tile=raster_cuda.TILE):
    """(B,P,F) bool: pixel p may see face f iff f is in the bins of p's tile."""
    H, W = hw
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    tile_of_pixel = ((ys // tile) * -(-W // tile) + xs // tile).reshape(-1)
    return raster_cuda.unpack_bins(bins, F)[:, tile_of_pixel]


def _render(mt, poses, tfs, cull, face_ok=None):
    p, Kt, tfs = raster.prepare_render_args(mt, poses, K, tfs)
    return raster._render_chunk(mt, p, Kt, tfs, *HW, backface_cull=cull,
                                face_ok=face_ok, **OPTS), (p, Kt, tfs)


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), cull=st.booleans(), n_pad=st.sampled_from([0, 5, 70]))
def test_render_from_tile_bins_equals_plain_render(seed, cull, n_pad):
    rng = np.random.default_rng(seed)
    mt = _soup(rng, int(rng.integers(1, 90)), n_pad)
    F = mt["faces"].shape[0]
    poses = _poses(rng, 2)
    ref, (p, Kt, tfs) = _render(mt, poses, None, cull)
    inp = raster_cuda.make_kernel_inputs(mt, p, Kt, tfs, backface_cull=cull)
    bins = raster_cuda.tile_bins(inp["rec"], *HW)
    assert bins.shape == (2, 9, (F + 31) // 32) and bins.dtype == torch.int32
    out, _ = _render(mt, poses, None, cull, face_ok=_face_ok_from_bins(bins, F, HW))
    assert ref["mask"].any()
    assert set(out) == set(ref) == {"rgb", "depth", "xyz", "mask", "tri", "normal"}
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    # invalid faces (padding, degenerate, behind the camera, culled) are in no bin
    s = raster.face_setup(mt, p, Kt, tfs, backface_cull=cull)
    un = raster_cuda.unpack_bins(bins, F)
    assert not (un & ~s["valid"][:, None]).any()
    assert un.sum().item() * raster_cuda.TILE**2 == raster_cuda.tile_face_tests(inp["rec"], *HW)


@pytest.mark.parametrize("cull", [False, True])
def test_bins_hold_every_winner_on_a_closed_mesh(cull):
    """The same property on a real mesh in real crop windows, stated the way
    the card-side check states it: each (tile, face) pair that holds a winning
    pixel is set."""
    from foundationpose_tpu_torch.core import geometry as geo

    mesh = meshio.make_icosphere_mesh(subdivisions=2, radius=0.05)
    mt = raster.make_mesh_tensors(mesh, bucket=True, device="cpu")
    rng = np.random.default_rng(3)
    poses = _poses(rng, 3)
    poses[:, :3, :3] = geo.so3_exp_map(rng.normal(size=(3, 3)).astype(np.float32)).numpy()
    poses[:, 2, 3] += 0.5
    tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, 0.1, HW)
    ref, (p, Kt, tfs) = _render(mt, poses, tfs, cull)
    assert ref["mask"].float().mean() > 0.3
    inp = raster_cuda.make_kernel_inputs(mt, p, Kt, tfs, backface_cull=cull)
    F = mt["faces"].shape[0]
    ok = _face_ok_from_bins(raster_cuda.tile_bins(inp["rec"], *HW), F, HW)
    tri = ref["tri"].reshape(3, -1)
    hit = tri >= 0
    assert torch.gather(ok, 2, tri.clamp_min(0)[..., None])[..., 0][hit].all()
    assert ok.float().mean() < 0.5  # binning removes work
    assert not ok[:, :, len(mesh.faces):].any()  # bucket padding is never binned


def test_bin_word_layout():
    """Face f is bit f % 32 of word f // 32; tiles are row-major; bit 31 sets
    the sign of the int32 word."""
    rec = torch.zeros((1, 70, 16))
    rec[..., 12], rec[..., 13], rec[..., 14], rec[..., 15] = 1e30, -1e30, 1e30, -1e30
    boxes = {0: (2.0, 5.0, 2.0, 5.0),        # tile (0,0)
             31: (17.0, 20.0, 2.0, 5.0),     # tile (0,1)
             33: (2.0, 20.0, 17.0, 18.0),    # tiles (1,0) and (1,1)
             69: (15.0, 16.0, 15.0, 16.0)}   # all four: touches each tile's edge pixel
    for f, (x0, x1, y0, y1) in boxes.items():
        rec[0, f, 12:16] = torch.tensor([x0, x1, y0, y1])
    bins = raster_cuda.tile_bins(rec, 32, 32)
    assert bins.shape == (1, 4, 3)
    expect = torch.tensor([[[1, 0, 1 << 5], [-(1 << 31), 0, 1 << 5],
                            [0, 1 << 1, 1 << 5], [0, 1 << 1, 1 << 5]]], dtype=torch.int32)
    assert torch.equal(bins, expect)
    un = raster_cuda.unpack_bins(bins, 70)
    assert un.shape == (1, 4, 70) and un.sum() == 8
    assert torch.equal(raster_cuda.tile_bins(rec, 32, 32), bins)  # same table every time


# ---------------------------------------------------------------------------
# texture sampling and lighting as the rasterizer kernel orders them


def _kernel_texture_shade(tex, uv, dif, use_light, w_ambient, w_diffuse):
    """Per pixel, in the kernel's order: x = u*Wt - 0.5, floor, the four taps
    (dy, dx) = (0,0) (0,1) (1,0) (1,1) with indices clamped as floats before
    the conversion, products rounded and summed one by one, then
    c*w_ambient + (dif*c)*w_diffuse and the clip."""
    Ht, Wt = tex.shape[:2]
    x = uv[:, 0] * float(Wt) - 0.5
    y = uv[:, 1] * float(Ht) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    acc = torch.zeros((len(uv), 3))
    for dy in (0, 1):
        for dx in (0, 1):
            xi = torch.clamp(x0 + float(dx), 0.0, float(Wt - 1)).to(torch.int32).long()
            yi = torch.clamp(y0 + float(dy), 0.0, float(Ht - 1)).to(torch.int32).long()
            wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
            for c in range(3):
                acc[:, c] = acc[:, c] + tex[..., c].reshape(-1)[yi * Wt + xi] * wgt
    if use_light:
        acc = acc * w_ambient + (dif[:, None] * acc) * w_diffuse
    return torch.clamp(acc, 0.0, 1.0)


@pytest.mark.parametrize("use_light", [True, False])
def test_in_kernel_texture_order_equals_plain_sampling(use_light):
    rng = np.random.default_rng(7)
    tex = torch.tensor(rng.uniform(0, 1, (24, 40, 3)), dtype=torch.float32)
    uv = torch.tensor(rng.uniform(-0.1, 1.1, (4000, 2)), dtype=torch.float32)  # clamps too
    dif = torch.tensor(rng.uniform(0, 1, 4000), dtype=torch.float32)
    ref = raster.shade(raster._sample_texture(tex, uv), dif, use_light, 0.8, 0.5)
    out = _kernel_texture_shade(tex, uv, dif, use_light, 0.8, 0.5)
    assert torch.equal(out, ref)


def test_in_kernel_texture_order_on_the_textured_render():
    """The textured box of the raster parity tests: per-pixel uv and diffuse
    term are read back from two untextured renders of the same mesh (uv as
    vertex colour, unlit; white, diffuse only), pushed through the kernel's
    arithmetic, and must give the textured render's rgb (1e-6: the read-back
    uv went through one more rounding than the render's own)."""
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    mesh.uv = np.random.default_rng(1).uniform(0.1, 0.9, (8, 2))
    yy, xx = np.mgrid[0:16, 0:16]
    mesh.texture = np.stack([xx * 16, yy * 16, (xx + yy) * 8], -1).astype(np.uint8)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = raster.as_f32(
        [[0.8, -0.36, 0.48], [0.6, 0.48, -0.64], [0.0, 0.8, 0.6]]).numpy()
    pose[:3, 3] = [0, 0, 0.5]
    Kc = np.array([[200.0, 0, 32], [0, 200.0, 32], [0, 0, 1]])
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    ref = raster.render_crops(mt, pose[None], Kc, None, out_hw=(64, 64))
    as_col = {k: v for k, v in mt.items() if k not in ("tex", "uv")}
    as_col["vertex_color"] = torch.cat([mt["uv"], torch.zeros_like(mt["uv"][:, :1])], dim=-1)
    uv = raster.render_crops(as_col, pose[None], Kc, None, out_hw=(64, 64), use_light=False)["rgb"]
    as_col["vertex_color"] = torch.ones_like(as_col["vertex_color"])
    dif = raster.render_crops(as_col, pose[None], Kc, None, out_hw=(64, 64),
                              w_ambient=0.0, w_diffuse=1.0)["rgb"][..., 0]
    hit = ref["mask"][0].reshape(-1)
    assert hit.float().mean() > 0.2
    out = _kernel_texture_shade(mt["tex"], uv[0].reshape(-1, 3)[:, :2], dif[0].reshape(-1),
                                True, 0.8, 0.5) * hit[:, None]
    assert (out - ref["rgb"][0].reshape(-1, 3)).abs().max() < 1e-6
    assert ref["rgb"][0].reshape(-1, 3)[hit].std(dim=0).min() > 0.01  # the texture shows


# ---------------------------------------------------------------------------
# the wrapper


def test_launches_are_counted_per_kernel_and_not_on_the_cpu():
    """One counter, one entry per kernel of the table; neither wrapper
    counts on the CPU."""
    assert set(kernels.LAUNCHES) == set(kernels.LIBRARIES) == {"K1s", "K1r", "K2"}
    assert all(isinstance(v, int) for v in kernels.LAUNCHES.values())
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.5
    before = dict(kernels.LAUNCHES)
    raster_cuda.render_crops(mt, pose[None], K, None, out_hw=HW)
    depth_cuda.preprocess(torch.full((24, 32), 0.5), torch.tensor(K, dtype=torch.float32))
    assert kernels.LAUNCHES == before


def test_kernel_entry_points_refuse_cpu_tensors():
    """The kernel path never falls back: handed CPU tensors it raises (before
    any build is tried), and only ``render_crops`` chooses the plain version,
    by the tensors' device."""
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.5
    p, Kt, tfs = raster.prepare_render_args(mt, pose[None], K, None)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.setup_cuda(mt, p, Kt, tfs, HW)
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.render_crops_cuda(mt, p, Kt, tfs, HW, True, 0.8, 0.5, (0.0, 0.0, 1.0),
                                      False, True)
    inp = raster_cuda.make_kernel_inputs(mt, p, Kt, tfs)
    scratch = {"vtab": inp["vtab"], "rec": inp["rec"],
               "bins": raster_cuda.tile_bins(inp["rec"], *HW)}
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.rasterize_cuda(mt, scratch, HW, True, 0.8, 0.5, True)
    with pytest.raises(ValueError, match="1..65535"):
        raster_cuda.setup_cuda(mt, p[:0], Kt, tfs[:0], HW)
    assert kernels.LAUNCHES == before


def test_launched_libraries_place_each_launch_function_by_its_address(tmp_path, monkeypatch):
    """``launched_libraries`` asks the dynamic loader which file holds the
    code of each launch function called, so two libraries built from one
    source with different ``-D`` switches (as the parts timer builds its
    parts) are told apart, and a library loaded through a link is named by
    its file."""
    src = tmp_path / "part.cpp"
    src.write_text('extern "C" int fp_part(void) { return PART; }\n')
    files, fns = {}, {}
    for part in (0, 1):
        files[part] = str(tmp_path / f"libpart{part}.so")
        subprocess.run([shutil.which("g++"), "-shared", "-fPIC", f"-DPART={part}", "-o",
                        files[part], str(src)], check=True)
    os.symlink(files[1], tmp_path / "link.so")
    fns = {0: ctypes.CDLL(files[0]).fp_part, 1: ctypes.CDLL(str(tmp_path / "link.so")).fp_part}
    assert (fns[0](), fns[1]()) == (0, 1)
    monkeypatch.setattr(kernels, "_LAUNCHED_FNS",
                        {"K1s": {id(fns[0]): fns[0]},
                         "K1r": {id(fns[0]): fns[0], id(fns[1]): fns[1]}, "K2": {}})
    assert kernels.launched_libraries() == {
        "K1s": {os.path.realpath(files[0])},
        "K1r": {os.path.realpath(files[0]), os.path.realpath(files[1])}, "K2": set()}
