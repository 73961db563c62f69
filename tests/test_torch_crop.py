"""Port parity for engine/crop.py::make_crop_batch against the JAX package's
``make_crop_batch(use_pallas=False)`` (its plain path on the CPU), same numpy
scene and poses, float32.

Gates: ``inputA``/``inputB``/``rgbA``/``rgbB``/``depthA`` within 1e-4 and
``mask``/``validB`` equal, on all but < 1e-4 of the pixels: a rasterised
silhouette pixel may flip between the two float32 implementations (and drag
the pixels of its dilated gate with it), everything else is the same
arithmetic to rounding.
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.engine.crop import make_crop_batch as jmake_crop_batch
from foundationpose_tpu.ops import raster as jraster
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.engine.crop import make_crop_batch
from foundationpose_tpu_torch.ops import raster

torch.set_num_threads(1)
K = np.array([[420.0, 0, 80], [0, 420.0, 60], [0, 0, 1]])
HW = (120, 160)
S = 64


def _scene(textured=False):
    rng = np.random.default_rng(0)
    mesh = meshio.make_icosphere_mesh(2, 0.05)
    mesh.vertices[:, 0] *= 1.4  # an ellipsoid: rotations matter
    mesh = meshio.Mesh(mesh.vertices, mesh.faces)
    if textured:
        v = mesh.vertices / np.linalg.norm(mesh.vertices, axis=-1, keepdims=True)
        mesh.uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                            np.arccos(np.clip(v[:, 2], -1, 1)) / np.pi], axis=-1)
        yy, xx = np.mgrid[0:32, 0:32]
        mesh.texture = np.stack([xx * 8, yy * 8, (xx + yy) * 4], axis=-1).astype(np.uint8)
    else:
        mesh.vertex_colors = (np.abs(mesh.vertices) / 0.07 * 255).clip(0, 255).astype(np.uint8)
    diameter = meshio.compute_mesh_diameter(mesh=mesh)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = np.asarray(jgeo.euler_matrix(0.4, -0.25, 0.6))[:3, :3]
    gt[:3, 3] = [0.005, -0.01, 0.5]
    jmt = jraster.make_mesh_tensors(mesh, bucket=True)
    obs = jraster.render_full_frame(jmt, gt[None], K, HW)
    rgb = np.asarray(obs["rgb"][0]) * 255.0
    depth = np.asarray(obs["depth"][0]).copy()
    depth[depth > 0] += rng.normal(0, 0.0005, (depth > 0).sum()).astype(np.float32)
    depth[depth == 0] = 0.8  # a backdrop, so observed depth exists off-object
    depth[rng.uniform(size=HW) < 0.03] = 0.0  # sensor holes
    xyz_map = np.asarray(jgeo.depth2xyzmap(depth, K))
    poses = np.tile(gt[None], (5, 1, 1))
    poses[1:, :3, 3] += rng.normal(0, 0.006, (4, 3)).astype(np.float32)
    poses[1:, :3, :3] = np.asarray(
        jgeo.so3_exp_map(rng.normal(0, 0.15, (4, 3)).astype(np.float32))) @ poses[1:, :3, :3]
    mt = raster.make_mesh_tensors(mesh, bucket=True, device="cpu")
    return dict(jmt=jmt, mt=mt, poses=poses, rgb=rgb.astype(np.float32),
                xyz_map=xyz_map, diameter=diameter)


def _frac_bad(a, b, tol):
    a, b = np.asarray(a, np.float32), b.numpy().astype(np.float32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    if d.ndim == 4:
        d = d.max(axis=-1)
    return float((d > tol).mean())


@pytest.mark.parametrize("use_normal", [False, True])
@pytest.mark.parametrize("gate_px", [0, 12])
@pytest.mark.parametrize("thres", [0.001, 0.1], ids=["refiner", "scorer"])
def test_make_crop_batch_matches_jax(thres, gate_px, use_normal):
    s = _scene()
    kw = dict(crop_ratio=1.2, out_size=S, z_invalid_thres=thres,
              use_normal=use_normal, gate_px=gate_px,
              normalize_xyz=not use_normal)  # the geo score runs un-normalised
    ref = jmake_crop_batch(s["jmt"], s["poses"], K, s["rgb"], s["xyz_map"],
                           s["diameter"], use_pallas=False, **kw)
    out = make_crop_batch(s["mt"], s["poses"], K, s["rgb"], s["xyz_map"],
                          s["diameter"], **kw)
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["tf_to_crops"].numpy(), np.asarray(ref["tf_to_crops"]), rtol=1e-6)
    assert np.asarray(ref["mask"]).mean() > 0.1 and np.asarray(ref["validB"]).mean() > 0.1
    for k in ("mask", "validB"):
        assert _frac_bad(np.asarray(ref[k]).astype(np.float32), out[k].float(), 0.5) < 1e-4, k
    for k in ("inputA", "inputB", "rgbA", "rgbB", "depthA") + (("normalA",) if use_normal else ()):
        assert _frac_bad(ref[k], out[k], 1e-4) < 1e-4, k
    assert out["inputA"].shape == (5, S, S, 6) and out["validB"].shape == (5, S, S, 1)


def test_make_crop_batch_textured_mesh():
    s = _scene(textured=True)
    ref = jmake_crop_batch(s["jmt"], s["poses"], K, s["rgb"], s["xyz_map"],
                           s["diameter"], out_size=S, use_pallas=False)
    out = make_crop_batch(s["mt"], s["poses"], K, s["rgb"], s["xyz_map"],
                          s["diameter"], out_size=S)
    for k in ("inputA", "inputB"):
        assert _frac_bad(ref[k], out[k], 1e-4) < 1e-4, k


def test_gate_zeroes_observed_side_only_beyond_margin():
    s = _scene()
    a = make_crop_batch(s["mt"], s["poses"], K, s["rgb"], s["xyz_map"], s["diameter"],
                        out_size=S, gate_px=0)
    b = make_crop_batch(s["mt"], s["poses"], K, s["rgb"], s["xyz_map"], s["diameter"],
                        out_size=S, gate_px=4)
    assert torch.equal(a["inputA"], b["inputA"])  # the rendered side is untouched
    assert (b["validB"].sum() < a["validB"].sum())
    inside = b["mask"][..., None]
    assert torch.equal(a["inputB"][inside.expand_as(a["inputB"])],
                       b["inputB"][inside.expand_as(b["inputB"])])
    far = ~torch.nn.functional.max_pool2d(
        b["mask"].float()[:, None], 9, stride=1, padding=4)[:, 0].bool()
    assert (b["inputB"][far] == 0).all() and not b["validB"][far].any()
