"""``engine/multi.py`` of the port against the JAX package:
``stack_mesh_tensors``, ``_vertex_colors_from_texture`` and
``MultiObjectTracker``.

Small size: three objects (a box, an icosphere, a textured icosphere), each
rendered into its own 120x160 stream, 64 px crops, float32 on the CPU, a
randomly initialised RefineNet carried across from flax. The JAX tracker maps
one refine step over a stacked object axis; the port renders object by object
and runs one RefineNet forward over the objects' crops.
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.engine import multi as jmulti
from foundationpose_tpu.engine import refiner as jrefiner_mod
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu_torch.core import geometry as geo, meshio
from foundationpose_tpu_torch.engine import multi
from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
from foundationpose_tpu_torch.models import convert
from foundationpose_tpu_torch.ops import raster, raster_cuda

torch.set_num_threads(1)
PX, HW = 64, (120, 160)
K = np.array([[250.0, 0, 80], [0, 250.0, 60], [0, 0, 1]])


def _meshes(mod):
    """The same three meshes built with either package's ``meshio``."""
    box = mod.make_box((0.08, 0.1, 0.06))
    box.vertex_colors = np.full((len(box.vertices), 3), 150, np.uint8)
    sph = mod.make_icosphere_mesh(subdivisions=2, radius=0.05)
    sph.vertex_colors = (np.abs(sph.vertices) / 0.05 * 255).astype(np.uint8)
    base = mod.make_icosphere_mesh(subdivisions=2, radius=0.045)
    tex = mod.Mesh(base.vertices * np.array([1.0, 0.7, 1.2]) + np.array([0.01, 0.0, -0.02]),
                   base.faces)
    v = tex.vertices / np.linalg.norm(tex.vertices, axis=-1, keepdims=True)
    tex.uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                       np.arccos(np.clip(v[:, 2], -1, 1)) / np.pi], axis=-1)
    yy, xx = np.mgrid[0:32, 0:48]
    tex.texture = np.stack([60 + 4 * xx, 40 + 6 * yy, 200 - 3 * xx], axis=-1).astype(np.uint8)
    return [box, sph, tex]


def _start_poses():
    poses = np.tile(np.eye(4)[None], (3, 1, 1))
    poses[0, :3, 3] = [0.02, 0.0, 0.5]
    poses[1, :3, 3] = [-0.03, 0.01, 0.6]
    poses[2, :3, 3] = [0.0, -0.02, 0.55]
    poses[:, :3, :3] = geo.so3_exp_map(
        np.float32([[0.3, -0.2, 0.1], [0.0, 0.4, -0.3], [-0.5, 0.1, 0.2]])).numpy()
    return poses


def _streams(meshes, poses):
    """One rendered rgb-d stream per object, at poses a little off ``poses``
    so that the refiner has something to correct."""
    rgbs, depths = [], []
    for i, mesh in enumerate(meshes):
        seen = poses[i].copy()
        seen[:3, 3] += [0.004, -0.003, 0.006]
        out = raster_cuda.render_full_frame(
            raster.make_mesh_tensors(mesh, device="cpu"), seen[None], K, HW)
        rgbs.append(out["rgb"][0].numpy() * 255)
        depths.append(out["depth"][0].numpy())
    return np.stack(rgbs), np.stack(depths)


def _rot_err(Ra, Rb):
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.arccos(np.clip((tr - 1) / 2, -1, 1))


@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    jr = jrefiner_mod.PoseRefiner(
        jrefiner_mod.RefinerConfig(input_size=PX, dtype="float32", use_pallas=False), seed=3)
    refiner = PoseRefiner(RefinerConfig(input_size=PX, dtype="float32"), device="cpu")
    path = str(tmp_path_factory.mktemp("w") / "refiner.npz")
    jagnostic.save_params_npz(path, jr.params, dtype=None)
    convert.load_flax_npz(path, refiner.net)
    tracker = multi.MultiObjectTracker(_meshes(meshio), refiner=refiner, device="cpu")
    jtracker = jmulti.MultiObjectTracker(_meshes(jmeshio), refiner=jr)
    return tracker, jtracker


def test_stack_mesh_tensors_matches_jax():
    """Shapes as the JAX package's own test states them, and the same arrays:
    centred, not bucketed, padded to the largest vertex and face count (pad
    faces index vertex 0), texture baked to vertex colours."""
    stacked, diams, centers = multi.stack_mesh_tensors(_meshes(meshio), device="cpu")
    jstacked, jdiams, jcenters = jmulti.stack_mesh_tensors(_meshes(jmeshio))
    assert stacked["pos"].shape == (3, 162, 3) and stacked["faces"].shape == (3, 320, 3)
    assert stacked["faces"].dtype == torch.int32
    assert (stacked["faces"][0, 12:] == 0).all()  # the box has 12 faces
    assert set(stacked) == {"pos", "faces", "vnormals", "vertex_color"}
    assert centers.shape == (3, 3) and diams.shape == (3,) and diams.dtype == np.float32
    assert float(diams[0]) > 0.1 and float(diams[1]) > 0.09
    for k, v in stacked.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstacked[k]), atol=1e-7)
    np.testing.assert_allclose(diams, np.asarray(jdiams), rtol=1e-6)
    np.testing.assert_allclose(centers, jcenters)
    assert np.ptp(stacked["vertex_color"][2].numpy(), axis=0).min() > 0.1  # baked texture
    plain = meshio.make_box((1, 1, 1))
    assert multi._vertex_colors_from_texture(plain) is plain  # nothing to bake


def test_track_matches_jax_tracker(trackers):
    """Two refine steps on three objects with the same random RefineNet:
    translation within 1e-4 m, rotation within 1e-3 rad (float32 nets on crops
    that agree to ~1e-4; the gate of one learned refine step)."""
    tracker, jtracker = trackers
    poses = _start_poses()
    rgbs, depths = _streams(_meshes(meshio), poses)
    Ks = np.stack([K] * 3)
    tracker.set_poses(poses)
    jtracker.set_poses(poses)
    out = tracker.track(rgbs, depths, Ks, iteration=2)
    ref = jtracker.track(rgbs, depths, Ks, iteration=2)
    assert out.shape == (3, 4, 4) and np.isfinite(out).all()
    assert np.linalg.norm(ref[:, :3, 3] - poses[:, :3, 3], axis=-1).min() > 1e-3  # all moved
    assert np.abs(out[:, :3, 3] - ref[:, :3, 3]).max() < 1e-4
    assert _rot_err(out[:, :3, :3], ref[:, :3, :3]).max() < 1e-3
    np.testing.assert_allclose(tracker.get_poses(), out)


def test_unpadded_objects_track_as_the_stacked_layout(trackers):
    """The tracker renders each object from its own unpadded tensors; a step
    from the slices of the stacked layout (vertices padded with zeros, faces
    with zero-area triangles on vertex 0) gives the same poses to 1e-6: the
    pad faces cover no pixel."""
    tracker = trackers[0]
    assert [int(m["faces"].shape[0]) for m in tracker.mesh_tensors] == [12, 320, 320]
    poses = _start_poses()
    rgbs, depths = _streams(_meshes(meshio), poses)
    Ks = np.stack([K] * 3)
    tracker.set_poses(poses)
    out = tracker.track(rgbs, depths, Ks, iteration=2)
    stacked, _, _ = multi.stack_mesh_tensors(_meshes(meshio), device="cpu")
    own = tracker.mesh_tensors
    tracker.mesh_tensors = [{k: v[o] for k, v in stacked.items()} for o in range(3)]
    try:
        tracker.set_poses(poses)
        padded = tracker.track(rgbs, depths, Ks, iteration=2)
    finally:
        tracker.mesh_tensors = own
    np.testing.assert_allclose(out, padded, atol=1e-6)


def test_zero_head_refiner_leaves_the_poses(trackers):
    """With RefineNet's output heads zeroed the step is the identity (the JAX
    package's own multi-object test), and ``set_poses`` / ``get_poses`` round
    trip through the centred-mesh frame."""
    refiner = PoseRefiner(RefinerConfig(input_size=PX, dtype="float32"), device="cpu")
    with torch.no_grad():
        for head in (refiner.net.trans_out, refiner.net.rot_out):
            head.weight.zero_()
            head.bias.zero_()
    meshes = _meshes(meshio)
    tracker = multi.MultiObjectTracker(meshes, refiner=refiner, device="cpu")
    with pytest.raises(RuntimeError, match="set_poses"):
        tracker.track(None, None, None)
    poses = _start_poses()
    tracker.set_poses(poses)
    np.testing.assert_allclose(tracker.get_poses(), poses, atol=1e-6)
    c = tracker.poses[2] @ np.linalg.inv(poses[2]).astype(np.float32)
    assert np.abs(c[:3, 3]).max() > 1e-3  # the third mesh is off-centre: frames differ
    rgbs, depths = _streams(meshes, poses)
    new = tracker.track(rgbs, depths, np.stack([K] * 3), iteration=2)
    np.testing.assert_allclose(new, poses, atol=1e-5)


def test_one_forward_over_objects_equals_single_forwards(trackers):
    """RefineNet has no operation across its batch axis, so the tracker's one
    forward over the O crops equals O forwards of one crop each (1e-5:
    the convolution library may pick another algorithm per batch size)."""
    net = trackers[0].refiner.net
    rng = np.random.default_rng(4)
    A = torch.tensor(rng.uniform(-1, 1, (3, PX, PX, 6)).astype(np.float32))
    B = torch.tensor(rng.uniform(-1, 1, (3, PX, PX, 6)).astype(np.float32))
    with torch.no_grad():
        together = net(A, B)
        alone = [net(A[i:i + 1], B[i:i + 1]) for i in range(3)]
    for k in ("trans", "rot"):
        np.testing.assert_allclose(
            together[k].numpy(), torch.cat([o[k] for o in alone]).numpy(), atol=1e-5)


def test_tracker_device_rule():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multi.MultiObjectTracker(_meshes(meshio)[:1])
        with pytest.raises(RuntimeError, match="CUDA"):
            multi.stack_mesh_tensors(_meshes(meshio)[:1])
