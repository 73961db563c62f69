"""Port parity, items 1-3: geometry, mesh helpers, rotation grid, metrics.

Every function of foundationpose_tpu_torch/core is held against its JAX
namesake on the same numpy inputs (fixed seed), float32, on the CPU.
Tolerance 1e-6 absolute unless stated: both sides evaluate the same closed
forms in float32 and differ by an ulp or two in transcendental functions and
summation order.
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo, meshio as jmeshio
from foundationpose_tpu.core import metrics as jmetrics, poses as jposes
from foundationpose_tpu.core import icosphere as jico
from foundationpose_tpu_torch.core import geometry as geo, meshio, metrics, poses
from foundationpose_tpu_torch.core import icosphere as ico, validate

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_poses(n, rng=RNG):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(jgeo.so3_exp_map(w))
    T[:, :3, 3] = rng.uniform([-0.1, -0.1, 0.4], [0.1, 0.1, 0.9], (n, 3))
    return T


@pytest.mark.parametrize("scale,atol", [(1.0, 1e-6), (3.0, 1e-6), (1e-3, 1e-5), (1e-5, 1e-5)])
def test_so3_exp_map(scale, atol):
    # 1e-5 through the map near zero angle: the Taylor/closed-form switch at
    # theta^2 = 1e-8 sits inside this range and sin/cos differ by an ulp
    w = (RNG.normal(size=(64, 3)) * scale).astype(np.float32)
    np.testing.assert_allclose(_np(geo.so3_exp_map(w)), np.asarray(jgeo.so3_exp_map(w)), atol=atol)


def test_so3_exp_map_zero_is_identity():
    assert np.allclose(_np(geo.so3_exp_map(np.zeros((2, 3), np.float32))), np.eye(3))


def test_rotation_6d_to_matrix():
    d6 = RNG.normal(size=(32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _np(geo.rotation_6d_to_matrix(d6)), np.asarray(jgeo.rotation_6d_to_matrix(d6)), atol=1e-6
    )


@pytest.mark.parametrize("angles", [(0.4, -0.25, 0.6), (0.0, 0.0, 0.0), (3.0, -1.2, 2.2)])
def test_euler_matrix(angles):
    np.testing.assert_allclose(
        _np(geo.euler_matrix(*angles)), np.asarray(jgeo.euler_matrix(*angles)), atol=1e-6
    )
    np.testing.assert_allclose(
        poses.euler_matrix_np(*angles), jposes.euler_matrix_np(*angles), atol=1e-12
    )


def test_egocentric_delta_parity():
    A = _rand_poses(16)
    dt = RNG.normal(size=(16, 3)).astype(np.float32) * 0.01
    dR = np.asarray(jgeo.so3_exp_map(RNG.normal(size=(16, 3)).astype(np.float32) * 0.2))
    ref = np.asarray(jgeo.egocentric_delta_pose_to_pose(A, dt, dR))
    out = geo.egocentric_delta_pose_to_pose(A, torch.tensor(dt), torch.tensor(dR))
    np.testing.assert_allclose(_np(out), ref, atol=1e-6)
    # the step translates the centre and rotates about it
    np.testing.assert_allclose(_np(out)[:, :3, 3] - A[:, :3, 3], dt, atol=1e-6)
    np.testing.assert_allclose(_np(out)[:, :3, :3] @ A[:, :3, :3].transpose(0, 2, 1), dR, atol=1e-5)


def test_project_pts():
    pts = RNG.normal(size=(100, 3)).astype(np.float32) * 0.05
    T = _rand_poses(4)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    cam = np.asarray(jgeo.transform_pts(pts, T))
    # pixel coordinates reach ~600: 1e-6 relative is 1e-4 absolute
    np.testing.assert_allclose(
        _np(geo.project_pts(cam, K)), np.asarray(jgeo.project_pts(cam, K)), rtol=1e-6, atol=1e-4
    )


@pytest.mark.parametrize("out_size", [(160, 160), (64, 64)])
def test_compute_crop_window_tf_batch(out_size):
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    P = _rand_poses(252, np.random.default_rng(3))
    ref = np.asarray(jgeo.compute_crop_window_tf_batch(P, K, 1.2, 0.17, out_size))
    out = _np(geo.compute_crop_window_tf_batch(P, K, 1.2, 0.17, out_size))
    # rounding is half-to-even on both sides; entries reach ~1e3 (offsets)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_depth2xyzmap():
    K = np.array([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]])
    depth = RNG.uniform(0.3, 1.2, (120, 160)).astype(np.float32)
    depth[RNG.uniform(size=depth.shape) < 0.1] = 0.0
    np.testing.assert_allclose(
        _np(geo.depth2xyzmap(depth, K)), np.asarray(jgeo.depth2xyzmap(depth, K)), atol=1e-6
    )
    np.testing.assert_allclose(
        _np(geo.depth2xyzmap(depth, K, zfar=0.8)),
        np.asarray(jgeo.depth2xyzmap(depth, K, zfar=0.8)), atol=1e-6,
    )


@pytest.mark.parametrize("zfar", [np.inf, 0.8])
def test_depth2xyzmap_batch(zfar):
    """Per-frame intrinsics, each frame as ``depth2xyzmap``; 1e-6."""
    rng = np.random.default_rng(11)
    Ks = np.stack([np.array([[f, 0, 80 + d], [0, f * 1.01, 60 - d], [0, 0, 1]])
                   for f, d in ((420.0, 0.0), (300.0, 3.5), (610.0, -7.25))])
    depth = rng.uniform(0.3, 1.2, (3, 60, 80)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    out = _np(geo.depth2xyzmap_batch(depth, Ks, zfar=zfar))
    assert out.shape == (3, 60, 80, 3)
    np.testing.assert_allclose(out, np.asarray(jgeo.depth2xyzmap_batch(depth, Ks, zfar=zfar)),
                               atol=1e-6)


def test_to_homo_and_transform_dirs():
    """float32, 1e-6: ``to_homo`` appends ones; ``transform_dirs`` rotates
    without translating, with ``transform_pts``'s batch rule (one tf per
    point set, and one tf per point)."""
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(geo.to_homo(pts)), np.asarray(jgeo.to_homo(pts)), atol=1e-6)
    assert geo.to_homo(torch.zeros(2, 3, dtype=torch.float64)).dtype == torch.float64
    tfs = _rand_poses(5, rng)
    for dirs, tf in ((pts, tfs), (pts[0], _rand_poses(7, rng)), (pts[0], tfs[0])):
        np.testing.assert_allclose(_np(geo.transform_dirs(dirs, tf)),
                                   np.asarray(jgeo.transform_dirs(dirs, tf)), atol=1e-6)


def test_normalize_rotation():
    """Columns of a scaled rotation block back to unit length; 1e-6."""
    rng = np.random.default_rng(13)
    poses = _rand_poses(6, rng)
    poses[:, :3, :3] *= rng.uniform(0.5, 2.0, (6, 1, 3)).astype(np.float32)
    out = _np(geo.normalize_rotation(poses))
    np.testing.assert_allclose(out, np.asarray(jgeo.normalize_rotation(poses)), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out[:, :3, :3], axis=-2), 1.0, atol=1e-6)
    np.testing.assert_array_equal(out[:, :3, 3], poses[:, :3, 3])


@pytest.mark.parametrize("hw,near_far", [((480, 640), (0.01, 10.0)), ((240, 320), (0.1, 2.5))])
def test_projection_matrix_from_intrinsics_bit_for_bit(hw, near_far):
    """numpy float64 on both sides: bit for bit."""
    K = np.array([[615.3, 0.7, 321.25], [0, 612.9, 239.5], [0, 0, 1]])
    out = geo.projection_matrix_from_intrinsics(K, *hw, *near_far)
    ref = jgeo.projection_matrix_from_intrinsics(K, *hw, *near_far)
    assert out.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# host helpers


def test_icosphere_views_equal():
    for n in (12, 40):
        np.testing.assert_array_equal(
            ico.sample_views_icosphere(n), jico.sample_views_icosphere(n)
        )


def test_rotation_grid_252_equal():
    grid = poses.make_rotation_grid()
    ref = jposes.make_rotation_grid()
    assert grid.shape == (252, 4, 4)
    # the JAX package may run its clustering through a compiled helper; the
    # kept set and its order are the same, the matrices agree to rounding
    np.testing.assert_allclose(grid, ref, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(min_n_views=12, inplane_step=120),
                                dict(min_n_views=40, inplane_step=60, cluster_angle_deg=45.0)])
def test_rotation_grid_variants(kw):
    np.testing.assert_allclose(
        poses.make_rotation_grid(**kw), jposes.make_rotation_grid(**kw), atol=1e-12
    )


def test_rotation_grid_with_symmetry():
    sym = np.stack([np.eye(4), jposes.euler_matrix_np(0, 0, np.pi)])
    a = poses.make_rotation_grid(symmetry_tfs=sym)
    b = jposes.make_rotation_grid(symmetry_tfs=sym)
    assert a.shape == b.shape and a.shape[0] < 252
    np.testing.assert_allclose(a, b, atol=1e-12)


def _pair(make, jmake, *a, **k):
    return make(*a, **k), jmake(*a, **k)


@pytest.mark.parametrize("name,args", [
    ("make_box", ((0.12, 0.08, 0.05),)),
    ("make_icosphere_mesh", (2, 0.05)),
    ("make_cylinder", (0.04, 0.1, 24)),
])
def test_primitives_diameter_watertight(name, args):
    m, jm = _pair(getattr(meshio, name), getattr(jmeshio, name), *args)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.faces, jm.faces)
    np.testing.assert_allclose(m.vertex_normals, jm.vertex_normals, atol=1e-12)
    assert meshio.compute_mesh_diameter(mesh=m) == jmeshio.compute_mesh_diameter(mesh=jm)
    assert meshio.is_watertight(m) == jmeshio.is_watertight(jm) is True


def test_open_mesh_not_watertight():
    m = meshio.make_box((0.1, 0.1, 0.1))
    m.faces = m.faces[:-1]
    jm = jmeshio.Mesh(m.vertices, m.faces)
    assert not meshio.is_watertight(m) and not jmeshio.is_watertight(jm)


def test_decimation_equal():
    m = meshio.make_icosphere_mesh(4, 0.05)
    m.vertex_colors = (np.abs(m.vertices) / 0.05 * 255).astype(np.uint8)
    jm = jmeshio.Mesh(m.vertices, m.faces, vertex_colors=m.vertex_colors)
    d = meshio.decimate_vertex_clustering(m, 1000)
    jd = jmeshio.decimate_vertex_clustering(jm, 1000)
    assert len(d.faces) <= 1000
    np.testing.assert_array_equal(d.faces, jd.faces)
    np.testing.assert_allclose(d.vertices, jd.vertices, atol=1e-12)
    np.testing.assert_array_equal(d.vertex_colors, jd.vertex_colors)


@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_mesh_readers(tmp_path, ext):
    m = meshio.make_box((0.1, 0.2, 0.3))
    m.vertex_colors = RNG.integers(0, 255, (8, 3)).astype(np.uint8)
    path = str(tmp_path / f"m.{ext}")
    (jmeshio.save_obj if ext == "obj" else jmeshio.save_ply)(path, m)  # the port only reads
    a, b = meshio.load_mesh(path), jmeshio.load_mesh(path)
    np.testing.assert_allclose(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.vertices.shape == m.vertices.shape


def test_add_and_adds_err():
    pts = meshio.make_icosphere_mesh(2, 0.05).vertices
    A, B = _rand_poses(2).astype(np.float64)
    # the JAX metrics run in float32: 1e-6 m on ~0.1 m distances
    assert abs(metrics.add_err(A, B, pts) - float(jmetrics.add_err(A, B, pts))) < 1e-6
    assert abs(metrics.adds_err(A, B, pts) - float(jmetrics.adds_err(A, B, pts))) < 1e-6


def test_validate_checks():
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    validate.check_intrinsics(K)
    with pytest.raises(ValueError):
        validate.check_intrinsics(np.eye(4))
    with pytest.raises(ValueError):
        validate.check_rgbd(np.zeros((4, 4, 3)), np.zeros((5, 4)))
    with pytest.raises(ValueError):
        validate.check_mask(np.zeros((3, 3)), (4, 4))
    with pytest.raises(ValueError):
        validate.check_pose(np.ones((4, 4)))
