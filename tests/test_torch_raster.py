"""Port parity for the module that holds the kernel: the crop rasterizer.

The port's plain ``render_crops`` (the CPU path and the reference the CUDA
kernel is held against on the card) against

(a) ``foundationpose_tpu.ops.raster.render_crops``: both are float32 and run
    the same arithmetic, so masks must agree on > 0.9999 of pixels and, on
    common pixels, depth/xyz within 1e-5 and rgb/normal within 1e-4
    (summation order differs; a winner can flip on a shared edge);
(b) ``render_crops_pallas(..., interpret=True, tile_rows=8)``, run exactly as
    tests/test_raster_pallas.py runs it, at that file's gates (mask > 0.999,
    depth/xyz 2e-3, rgb 6e-3, normal 9e-3): the slack is the Pallas kernel's
    bf16 tables, not the port.

The CUDA kernels themselves cannot run here; what surrounds them can: the
face records and vertex tables the rasterizer reads are emulated pixel by
pixel and held against the plain version, and the wrapper's dispatch rule is
checked. The tile bins and the in-kernel texture arithmetic are in
tests/test_torch_raster_bins.py.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.ops import raster as jraster
from foundationpose_tpu.ops.raster_pallas import render_crops_pallas
from foundationpose_tpu_torch.core import geometry as geo, meshio
from foundationpose_tpu_torch.ops import kernels, raster, raster_cuda

torch.set_num_threads(1)
K = np.array([[200.0, 0, 32], [0, 200.0, 32], [0, 0, 1]])
HW = (64, 64)
PALLAS_TOL = {"depth": 2e-3, "xyz": 2e-3, "rgb": 6e-3, "normal": 9e-3}
XLA_TOL = {"depth": 1e-5, "xyz": 1e-5, "rgb": 1e-4, "normal": 1e-4}


def _cube():
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    mesh.vertex_colors = np.random.default_rng(0).integers(0, 255, (8, 3)).astype(np.uint8)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jgeo.euler_matrix(0.3, 0.5, 0.2))[:3, :3]
    pose[:3, 3] = [0.01, -0.01, 0.5]
    return mesh, pose[None]


def _sphere_batch():
    mesh = meshio.make_icosphere_mesh(subdivisions=2, radius=0.05)
    mesh.vertex_colors = (np.abs(mesh.vertices) / 0.05 * 255).astype(np.uint8)
    poses = np.tile(np.eye(4)[None], (3, 1, 1)).astype(np.float32)
    poses[:, 2, 3] = [0.4, 0.5, 0.6]
    poses[1, :3, :3] = np.asarray(jgeo.euler_matrix(0.2, 0.1, 0.9))[:3, :3]
    return mesh, poses


def _textured_box():
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    mesh.uv = np.random.default_rng(1).uniform(0.1, 0.9, (8, 2))
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8, 0] = 255
    tex[:, 8:, 1] = 255
    mesh.texture = tex
    pose = np.eye(4, dtype=np.float32)  # frontal, as the Pallas kernel's own test has it
    pose[:3, 3] = [0, 0, 0.5]
    return mesh, pose[None]


CASES = {"cube": _cube, "sphere_batch": _sphere_batch, "textured_box": _textured_box}


def _identity_tfs(n):
    return np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))


def _compare(ref, out, tol, min_agree, keys=("depth", "xyz", "rgb", "normal")):
    mref = np.asarray(ref["mask"])
    mout = out["mask"].numpy()
    assert mref.any()
    assert (mref == mout).mean() > min_agree
    both = mref & mout
    for k in keys:
        a = np.asarray(ref[k])[both]
        b = out[k].numpy()[both]
        assert np.abs(a - b).max() < tol[k], f"{k}: max diff {np.abs(a - b).max()}"


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_reference(case, bucket):
    mesh, poses = CASES[case]()
    tfs = _identity_tfs(len(poses))
    ref = jraster.render_crops(jraster.make_mesh_tensors(mesh, bucket=bucket), poses, K, tfs, out_hw=HW)
    mt = raster.make_mesh_tensors(mesh, bucket=bucket, device="cpu")
    out = raster.render_crops(mt, poses, K, tfs, out_hw=HW)
    _compare(ref, out, XLA_TOL, 0.9999)
    # the winning face ids agree wherever both hit, except on shared edges:
    # there two faces score the same to an ulp and either may win (the
    # interpolated values above agree either way)
    both = np.asarray(ref["mask"]) & out["mask"].numpy()
    assert (np.asarray(ref["tri"])[both] == out["tri"].numpy()[both]).mean() > 0.99


def test_plain_matches_xla_on_real_crop_windows():
    """Non-identity crop transforms from compute_crop_window_tf_batch."""
    mesh, _ = _sphere_batch()
    Kc = np.array([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]])
    rng = np.random.default_rng(5)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (4, 1, 1))
    poses[:, :3, :3] = np.asarray(jgeo.so3_exp_map(rng.normal(size=(4, 3)).astype(np.float32)))
    poses[:, :3, 3] = rng.uniform([-0.05, -0.05, 0.4], [0.05, 0.05, 0.7], (4, 3))
    tfs = geo.compute_crop_window_tf_batch(poses, Kc, 1.2, 0.1, HW).numpy()
    np.testing.assert_allclose(
        tfs, np.asarray(jgeo.compute_crop_window_tf_batch(poses, Kc, 1.2, 0.1, HW)), rtol=1e-6)
    ref = jraster.render_crops(jraster.make_mesh_tensors(mesh), poses, Kc, tfs, out_hw=HW)
    out = raster.render_crops(raster.make_mesh_tensors(mesh, device="cpu"), poses, Kc, tfs, out_hw=HW)
    assert np.asarray(ref["mask"]).mean() > 0.3  # the windows frame the object
    _compare(ref, out, XLA_TOL, 0.9999)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    mesh, poses = CASES[case]()
    tfs = _identity_tfs(len(poses))
    use_light = case != "textured_box"
    fast = render_crops_pallas(
        jraster.make_mesh_tensors(mesh), poses, K, tfs, out_hw=HW,
        use_light=use_light, interpret=True, tile_rows=8,
    )
    out = raster_cuda.render_crops(
        raster.make_mesh_tensors(mesh, device="cpu"), poses, K, tfs, out_hw=HW,
        use_light=use_light,
    )
    assert set(out) == set(fast) == {"rgb", "depth", "xyz", "mask", "normal"}
    _compare(fast, out, PALLAS_TOL, 0.999)


def test_without_normal_matches_pallas_interpret():
    mesh, poses = _sphere_batch()
    poses = poses[:2]
    tfs = _identity_tfs(2)
    fast = render_crops_pallas(
        jraster.make_mesh_tensors(mesh), poses, K, tfs, out_hw=HW,
        interpret=True, tile_rows=8, with_normal=False,
    )
    out = raster_cuda.render_crops(
        raster.make_mesh_tensors(mesh, device="cpu"), poses, K, tfs, out_hw=HW,
        with_normal=False,
    )
    assert "normal" not in out and "normal" not in fast
    _compare(fast, out, PALLAS_TOL, 0.999, keys=("depth", "xyz", "rgb"))


def test_behind_camera_draws_nothing():
    mesh = meshio.make_box((0.1, 0.1, 0.1))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, -0.5]
    out = raster_cuda.render_crops(
        raster.make_mesh_tensors(mesh, device="cpu"), pose[None], K, None, out_hw=HW
    )
    assert not out["mask"].any()
    for k in ("rgb", "depth", "xyz", "normal"):
        assert torch.isfinite(out[k]).all() and (out[k] == 0).all()


def test_backface_cull_identical_on_closed_mesh():
    mesh, _ = _sphere_batch()
    assert meshio.is_watertight(mesh)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jgeo.euler_matrix(0.4, -0.2, 0.7))[:3, :3]
    pose[2, 3] = 0.5
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    a = raster.render_crops(mt, pose[None], K, None, out_hw=HW, backface_cull=False)
    b = raster.render_crops(mt, pose[None], K, None, out_hw=HW, backface_cull=True)
    assert (a["mask"] == b["mask"]).all() and a["mask"].any()
    for k in ("depth", "rgb", "xyz", "normal"):
        assert (a[k] - b[k]).abs().max() <= 1e-5
    # and the culled render still matches the Pallas kernel's culled render
    fast = render_crops_pallas(jraster.make_mesh_tensors(mesh), pose[None], K,
                               _identity_tfs(1), out_hw=HW, interpret=True,
                               backface_cull=True)
    _compare(fast, b, PALLAS_TOL, 0.999)


def test_bucketed_tensors_shapes_and_render():
    mesh, poses = _sphere_batch()
    mt = raster.make_mesh_tensors(mesh, bucket=True, device="cpu")
    jmt = jraster.make_mesh_tensors(mesh, bucket=True)
    assert set(mt) == set(jmt)
    for k in mt:
        assert tuple(mt[k].shape) == tuple(jmt[k].shape), k
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(jmt[k]), atol=1e-7)
    a = raster.render_crops(mt, poses, K, None, out_hw=HW)
    b = raster.render_crops(raster.make_mesh_tensors(mesh, device="cpu"), poses, K, None, out_hw=HW)
    assert (a["mask"] == b["mask"]).all()
    assert (a["depth"] - b["depth"]).abs().max() == 0  # pad faces never win


def test_bucketed_texture_and_face_cap():
    mesh, _ = _textured_box()
    big = meshio.make_icosphere_mesh(4, 0.05)  # 5120 faces
    big.uv = np.random.default_rng(2).uniform(0.05, 0.95, (len(big.vertices), 2))
    big.texture = mesh.texture
    mt = raster.make_mesh_tensors(big, max_faces=1000, bucket=True, device="cpu")
    jmt = jraster.make_mesh_tensors(big, max_faces=1000, bucket=True)
    for k in mt:
        assert tuple(mt[k].shape) == tuple(jmt[k].shape), k
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(jmt[k]), atol=1e-7)
    assert mt["faces"].shape[0] == 1024 and mt["tex"].shape[:2] == (256, 256)


# ---------------------------------------------------------------------------
# what surrounds the CUDA kernel


def _emulate_kernel(inp, B, H, W):
    """The kernel's per-pixel arithmetic on its own inputs, in torch: bbox
    reject, inside test on the record's barycentric coefficients, 1/z score,
    lowest face index on ties, then the winner's attributes from the vertex
    table (layout as documented in csrc/raster.cu)."""
    rec, vtab, faces = inp["rec"], inp["vtab"], inp["faces"].long()
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    px, py = xs.reshape(1, -1, 1), ys.reshape(1, -1, 1)
    r = rec[:, None]  # (B,1,F,16)
    w = [r[..., 3 * k] * px + r[..., 3 * k + 1] * py + r[..., 3 * k + 2] for k in range(3)]
    tile_ok = ((r[..., 13] >= (px // 16) * 16) & (r[..., 12] <= (px // 16) * 16 + 15)
               & (r[..., 15] >= (py // 16) * 16) & (r[..., 14] <= (py // 16) * 16 + 15))
    inside = (w[0] >= -1e-6) & (w[1] >= -1e-6) & (w[2] >= -1e-6) & tile_ok
    score = w[0] * r[..., 9] + w[1] * r[..., 10] + w[2] * r[..., 11]
    score = torch.where(inside, score, torch.full_like(score, -1.0))
    best, tri = score.max(dim=-1)
    hit = best > 0
    vids = faces[tri]  # (B,P,3)
    bidx = torch.arange(B)[:, None, None]
    corner = vtab[bidx, vids]  # (B,P,3,8)
    wsel = torch.stack([torch.gather(wk, 2, tri[..., None])[..., 0] for wk in w], dim=-1)
    u = wsel / corner[..., 2].clamp_min(raster.ZNEAR)
    u = u / u.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    xyz = (u[..., None] * corner[..., :3]).sum(dim=2)
    return hit.reshape(B, H, W), tri.reshape(B, H, W), (xyz * hit[..., None]).reshape(B, H, W, 3)


@pytest.mark.parametrize("cull", [False, True])
def test_kernel_inputs_reproduce_plain_render(cull):
    mesh, poses = _sphere_batch()
    mt = raster.make_mesh_tensors(mesh, bucket=True, device="cpu")
    p, Kt, tfs = raster.prepare_render_args(mt, poses, K, None)
    inp = raster_cuda.make_kernel_inputs(mt, p, Kt, tfs, backface_cull=cull)
    F, V = mt["faces"].shape[0], mt["pos"].shape[0]
    assert inp["rec"].shape == (3, F, 16) and inp["vtab"].shape == (3, V, 8)
    assert inp["faces"].dtype == torch.int32
    # pad / culled / degenerate faces carry an empty bbox
    n_real = len(mesh.faces)
    assert (inp["rec"][:, n_real:, 12] > inp["rec"][:, n_real:, 13]).all()
    hit, tri, xyz = _emulate_kernel(inp, 3, *HW)
    ref = raster.render_crops(mt, poses, K, None, out_hw=HW, backface_cull=cull)
    assert (hit == ref["mask"]).all()
    # shared-edge ties may go to either neighbour (scores equal to an ulp);
    # the interpolated position is the same from both
    assert (tri[hit] == ref["tri"][hit]).float().mean() > 0.99
    assert (xyz - ref["xyz"]).abs().max() < 1e-5
    tests = raster_cuda.tile_face_tests(inp["rec"], *HW)
    assert 0 < tests < 3 * HW[0] * HW[1] * n_real  # tile rejection removes work


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    mesh, poses = _cube()
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    before = dict(kernels.LAUNCHES)
    out = raster_cuda.render_crops(mt, poses, K, None, out_hw=HW)
    ref = raster.render_crops(mt, poses, K, None, out_hw=HW)
    assert kernels.LAUNCHES == before  # no kernel launch on the CPU
    assert "tri" not in out
    for k in out:
        assert torch.equal(out[k], ref[k])


@pytest.mark.parametrize("name", list(kernels.LIBRARIES))
def test_kernel_build_raises_without_a_compiler(name):
    """No silent fallback: where nvcc is missing, launching any kernel of the
    table raises, before it loads or counts anything."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA compiler is present; the build would succeed")
    before = dict(kernels.LAUNCHES)
    with pytest.raises((OSError, RuntimeError)):
        kernels.launch(name, "cpu")
    assert kernels._fns is None and kernels._paths is None
    assert kernels.LAUNCHES == before


def test_make_mesh_tensors_device_rule():
    mesh, _ = _cube()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        raster.make_mesh_tensors(mesh)
