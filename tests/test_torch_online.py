"""The port's online model-free tracker (foundationpose_tpu_torch/slam/online.py)
against the JAX package's (tests/test_online.py through the port).

Frames of the chiral L-shape are rendered once by the port's plain rasterizer
and fed, as numpy arrays, to both packages. ``depth_map_mesh`` is host numpy
and is held bit for bit. Tracked poses are held by ADD on the object's
vertices, within 0.5 % of its diameter: each step is a chain of projective
ICP iterations whose hard inlier threshold cannot be held step by step
(``tests/test_torch_geometric.py``).
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.field.runner import FieldConfig as JFieldConfig
from foundationpose_tpu.slam import online as jonline
from foundationpose_tpu_torch.core import meshio, metrics, poses as poses_mod
from foundationpose_tpu_torch.field.runner import FieldConfig
from foundationpose_tpu_torch.ops import raster
from foundationpose_tpu_torch.slam import online

K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
HW = (120, 160)
TINY_FIELD = dict(
    n_step=10, n_rand=256, n_samples=8, n_samples_around_depth=8, num_levels=2,
    log2_hashmap_size=10, base_res=8, finest_res=16, triplane_resolutions=(8, 16),
    triplane_channels=2, trunc=0.02, occ_resolution=16, mask_dilate_first=8, mask_dilate=6,
    mesh_resolution=0.02,
)
TINY = dict(keyframe_min_rot_deg=1.0, keyframe_min_trans=0.005, retrain_every_keyframes=100,
            track_iterations=2, mesh_stride=4)


def l_mesh():
    boxes = [
        meshio.make_box((0.12, 0.04, 0.04)),
        meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0]),
        meshio.make_box((0.04, 0.04, 0.07)).translated([-0.04, 0.0, 0.055]),
    ]
    verts = np.concatenate([m.vertices for m in boxes])
    offs = np.cumsum([0] + [len(m.vertices) for m in boxes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(boxes, offs)])
    m = meshio.Mesh(verts, faces)
    m.vertex_colors = ((np.abs(verts) / np.abs(verts).max()) * 255).astype(np.uint8)
    return m


def render(mt, ob_in_cam):
    out = raster.render_full_frame(mt, ob_in_cam[None].astype(np.float32), K, HW)
    return ((out["rgb"][0].numpy() * 255).astype(np.float32),
            out["depth"][0].numpy().astype(np.float32),
            out["mask"][0].numpy().astype(np.uint8))


def smoke_frames():
    """tests/test_online.py::test_online_smoke's three frames."""
    mt = raster.make_mesh_tensors(l_mesh(), device="cpu")
    pose0 = np.eye(4)
    pose0[:3, 3] = [0.0, 0.0, 0.45]
    frames = [render(mt, pose0)]
    for i in (1, 2):
        p = pose0.copy()
        p[:3, :3] = poses_mod.euler_matrix_np(0.0, 0.04 * i, 0.0)[:3, :3]
        frames.append(render(mt, p))
    return frames


def test_depth_map_mesh_bit_for_bit():
    mt = raster.make_mesh_tensors(meshio.make_box((0.1, 0.1, 0.1)), device="cpu")
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 0.5]
    _, depth, mask = render(mt, pose)
    for stride in (2, 3):
        dm = online.depth_map_mesh(depth, mask, K, stride=stride)
        ref = jonline.depth_map_mesh(depth, mask, K, stride=stride)
        np.testing.assert_array_equal(dm.vertices, ref.vertices)
        np.testing.assert_array_equal(dm.faces, ref.faces)
        assert dm.faces.dtype == ref.faces.dtype
    # tests/test_online.py::test_depth_map_mesh: on the observed surface
    dm = online.depth_map_mesh(depth, mask, K, stride=2)
    assert len(dm.faces) > 100 and dm.faces.max() < len(dm.vertices)
    np.testing.assert_allclose(dm.vertices[:, 2].min(), 0.45, atol=0.01)


def test_online_smoke_matches_jax():
    """init + 2 steps on the tiny config of tests/test_online.py:49: the same
    keyframes and tracked poses as the JAX tracker (ADD < 0.5 % of the
    diameter); then the port alone runs a retrain, pose-graph BA and a
    finalize with a texture bake (the loop's other entry points)."""
    frames = smoke_frames()
    mine = online.ModelFreeTracker(K, online.OnlineConfig(**TINY, field=FieldConfig(**TINY_FIELD)),
                                   device="cpu")
    ref = jonline.ModelFreeTracker(K, jonline.OnlineConfig(**TINY,
                                                           field=JFieldConfig(**TINY_FIELD)))
    np.testing.assert_array_equal(mine.init(*frames[0]), ref.init(*frames[0]))
    assert len(mine.mesh.faces) == len(ref.mesh.faces)
    verts = l_mesh().vertices
    diameter = meshio.compute_mesh_diameter(mesh=l_mesh())
    for rgb, depth, mask in frames[1:]:
        a = mine.step(rgb, depth, mask=mask)
        b = ref.step(rgb, depth, mask=mask)
        assert np.isfinite(mine.cam_in_ob).all()
        assert metrics.add_err(a, b, verts) < 0.005 * diameter
        assert len(mine.keyframes) == len(ref.keyframes)
    assert len(mine.keyframes) == 3  # both steps moved past the tiny thresholds

    mine.retrain(n_step=10)
    assert len(mine.mesh.faces) > 0 and np.isfinite(mine.cam_in_ob).all()
    cost = mine.run_pose_graph_ba(n_landmarks=64, rounds=1)
    assert np.isfinite(cost)
    mesh_rec, optimized = mine.finalize(bake=True, tex_res=64)
    assert len(mesh_rec.faces) > 0 and mesh_rec.texture is not None
    assert optimized.shape == (3, 4, 4) and np.isfinite(optimized).all()


def test_tracker_device_rule():
    """``device=None`` means cuda and raises without a card; the refiner and
    the tracking mesh live on the tracker's device."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            online.ModelFreeTracker(K)
    t = online.ModelFreeTracker(K, online.OnlineConfig(**TINY), device="cpu")
    assert t.refiner.device.type == "cpu" and t.refiner.cfg.tau_rel == 0.12
    t.init(*smoke_frames()[0])
    assert t.mesh_tensors["pos"].device.type == "cpu"
    assert "bucket" not in t.mesh_tensors and t.mesh_tensors["faces"].shape[0] == len(t.mesh.faces)
    with pytest.raises(RuntimeError, match="init"):
        online.ModelFreeTracker(K, device="cpu").step(*smoke_frames()[1])


@pytest.mark.slow
def test_online_tracking_loop():
    """tests/test_online.py::test_online_tracking_loop through the port: an
    orbit of 7 frames tracked within 2 cm and 8 degrees, at least three
    keyframes, and a reconstruction within 3 cm of the true surface."""
    mesh = l_mesh()
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    cam0 = np.eye(4)
    cam0[:3, 3] = [0.0, 0.0, -0.45]
    traj = [cam0]
    for i in range(1, 8):
        c = np.eye(4)
        c[:3, :3] = poses_mod.euler_matrix_np(0.0, 0.035 * i, 0.012 * i)[:3, :3]
        c[:3, 3] = c[:3, :3] @ cam0[:3, 3]
        traj.append(c)
    cfg = online.OnlineConfig(
        keyframe_min_rot_deg=3.0, keyframe_min_trans=0.01, retrain_every_keyframes=100,
        track_iterations=6, mesh_stride=2,
        field=FieldConfig(n_step=120, n_rand=1024, n_samples=24, n_samples_around_depth=24,
                          num_levels=4, log2_hashmap_size=14, base_res=8, finest_res=48,
                          triplane_resolutions=(8, 16, 32), triplane_channels=2, trunc=0.02,
                          occ_resolution=32, mask_dilate_first=8, mask_dilate=6,
                          mesh_resolution=0.02))
    tracker = online.ModelFreeTracker(K, cfg, device="cpu")
    tracker.init(*render(mt, np.linalg.inv(traj[0])))
    errs = []
    for cam in traj[1:]:
        tracker.step(*render(mt, np.linalg.inv(cam)))
        expected = np.linalg.inv(traj[0]) @ cam
        est = tracker.cam_in_ob
        dr = np.arccos(np.clip((np.trace(est[:3, :3] @ expected[:3, :3].T) - 1) / 2, -1, 1))
        errs.append((np.linalg.norm(est[:3, 3] - expected[:3, 3]), np.degrees(dr)))
    errs = np.array(errs)
    assert errs[:, 0].max() < 0.02 and errs[:, 1].max() < 8.0, errs
    assert len(tracker.keyframes) >= 3

    mesh_rec, _ = tracker.finalize(bake=False)
    assert len(mesh_rec.faces) > 50
    from scipy.spatial import cKDTree

    rec = mesh_rec.vertices @ traj[0][:3, :3].T + traj[0][:3, 3]
    tree = cKDTree(np.concatenate([mesh.vertices, mesh.vertices[mesh.faces].mean(axis=1)]))
    dd, _ = tree.query(rec[:: max(1, len(rec) // 500)], k=1)
    assert np.median(dd) < 0.03, np.median(dd)
