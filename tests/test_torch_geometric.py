"""Geometric (no-weights) mode of the port against the JAX package:
``se3_exp_map``, the two closed-form ICP solvers, one ICP iteration, and
``register`` -> ``track_one`` with ``GeometricRefiner`` + ``GeometricScorer``.

Scene: the demo's chiral L-shape over a flat backdrop at 240x320, 126
hypotheses (``min_n_views=12, inplane_step=120``), 64 px crops, both packages
on the CPU with their plain rasterizers.
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.engine import estimator as jest
from foundationpose_tpu.engine import geometric as jgeometric
from foundationpose_tpu_torch.apps import demo_synthetic as demo
from foundationpose_tpu_torch.apps import run_pose
from foundationpose_tpu_torch.core import geometry as geo, metrics
from foundationpose_tpu_torch.engine import estimator as est_mod
from foundationpose_tpu_torch.engine import geometric

torch.set_num_threads(1)
PX = 64
SCHEDULE = dict(min_n_views=12, inplane_step=120, register_iterations=4,
                final_refine_iterations=2)


def _rot_err(Ra, Rb):
    tr = np.einsum("...ij,...ij->...", Ra, Rb)
    return np.arccos(np.clip((tr - 1) / 2, -1, 1))


@pytest.fixture(scope="module")
def world():
    scene = demo.make_scene((240, 320), device="cpu")
    m = scene["mesh"]
    est = demo.build_estimator(m, device="cpu", input_size=PX, mode="geometric",
                               config=est_mod.EstimatorConfig(**SCHEDULE))
    gcfg = jgeometric.GeometricConfig(input_size=PX)
    jestm = jest.FoundationPoseTPU(
        jmeshio.Mesh(m.vertices, m.faces, vertex_colors=m.vertex_colors),
        config=jest.EstimatorConfig(**SCHEDULE),
        refiner=jgeometric.GeometricRefiner(gcfg), scorer=jgeometric.GeometricScorer(gcfg))
    K = scene["K"].astype(np.float32)
    _, xyz_map = est_mod.preprocess_depth(torch.tensor(scene["depth"]), torch.tensor(K))
    return dict(scene=scene, est=est, jest=jestm, K=K, rgb=scene["rgb"].astype(np.float32),
                xyz_map=xyz_map.numpy())


@pytest.mark.parametrize("case", ["random", "small_angle", "batch_axes"])
def test_se3_exp_map_matches_jax(case):
    """1e-6: the same float32 formula on both sides (sin, cos and a 3x3
    product may differ in the last bit)."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (7, 6)).astype(np.float32)
    if case == "small_angle":  # the Taylor branch below theta^2 = 1e-8
        xi[:, 3:] *= 1e-6
    elif case == "batch_axes":
        xi = xi[:6].reshape(2, 3, 6)
    out = geo.se3_exp_map(xi).numpy()
    assert out.shape == (*xi.shape[:-1], 4, 4)
    np.testing.assert_allclose(out, np.asarray(jgeo.se3_exp_map(xi)), atol=1e-6)
    R = out[..., :3, :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    # a pure translation is the translation itself (input order: translation first)
    pure = geo.se3_exp_map(np.array([[0.1, -0.2, 0.3, 0, 0, 0]], np.float32))[0].numpy()
    np.testing.assert_allclose(pure[:3, 3], [0.1, -0.2, 0.3], atol=1e-7)


def _point_sets(seed, n_sets=4, P=3000):
    """Weighted point sets related by a small rigid motion plus noise; the
    last set keeps 5 weighted points (weight sum <= 10 -> identity)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 0.05, (n_sets, P, 3)).astype(np.float32) + np.float32([0, 0, 0.5])
    T = geo.se3_exp_map(np.float32([[0.004, -0.003, 0.002, 0.02, -0.01, 0.03]]))[0].numpy()
    q = p @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 5e-4, p.shape).astype(np.float32)
    n = rng.normal(0, 1, p.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = (rng.uniform(0, 1, (n_sets, P)) > 0.3).astype(np.float32)
    w[-1] = 0
    w[-1, :5] = 1
    return p, q, n, w, T


@pytest.mark.parametrize("solver", ["point_to_plane", "kabsch"])
def test_icp_solvers_match_jax(solver):
    """The batched solve against the JAX solve set by set: rotation within
    1e-5, translation within 1e-6 m (float32 sums over 3000 points in another
    order, then a 6x6 solve or a 4x4 eigenvector; ``q`` and ``-q`` of the
    latter give the same rotation, so the rotation is what is compared). The
    batched form sums the point-to-point block in closed form, never per
    point."""
    p, q, n, w, T = _point_sets(1)
    if solver == "point_to_plane":
        out = geometric._point_to_plane_delta(p, q, n, w).numpy()
        ref = np.stack([np.asarray(jgeometric._point_to_plane_delta(p[i], q[i], n[i], w[i]))
                        for i in range(len(p))])
    else:
        out = geometric._kabsch_delta(p, q, w).numpy()
        ref = np.stack([np.asarray(jgeometric._kabsch_delta(p[i], q[i], w[i]))
                        for i in range(len(p))])
    np.testing.assert_allclose(out[:, :3, :3], ref[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(out[:, :3, 3], ref[:, :3, 3], atol=1e-6)
    np.testing.assert_array_equal(out[-1], np.eye(4))  # weight sum <= 10
    # the fit recovers the motion (kabsch exactly; one damped linearised step nearly)
    assert np.abs(out[0, :3, 3] - T[:3, 3]).max() < 2e-3
    assert _rot_err(out[0, :3, :3], T[:3, :3]) < 5e-3
    # unbatched input works like one set of the batch
    single = (geometric._kabsch_delta(p[0], q[0], w[0]) if solver == "kabsch"
              else geometric._point_to_plane_delta(p[0], q[0], n[0], w[0])).numpy()
    np.testing.assert_allclose(single, out[0], atol=1e-6)


def _register_hypotheses(w):
    est = w["est"]
    center, _ = est_mod.guess_translation(
        est_mod.preprocess_depth(torch.tensor(w["scene"]["depth"]), torch.tensor(w["K"]))[0],
        torch.tensor(w["scene"]["mask"]), torch.tensor(w["K"]))
    hyp = est.rot_grid.copy()
    hyp[:, :3, 3] = center.numpy()
    return hyp


def test_one_icp_iteration_matches_jax(world):
    """One ICP iteration on the 126 register hypotheses: translation within
    1e-4 m and rotation within 1e-3 rad on at least 95 % of them. The rest are
    hypotheses on which a pixel's association error lies within an ulp of the
    hard inlier threshold ``err < tau``: float32 sums over 4096 pixels run in
    another order than XLA's, tau moves in its last bit, a pixel falls in or
    out, and on a wrong-basin hypothesis with few inliers one pixel moves the
    step visibly. The median difference is far below the gate."""
    est, je, w = world["est"], world["jest"], world
    hyp = _register_hypotheses(w)
    out = geometric._icp_refine(est.refiner.cfg, est.mesh_tensors, hyp, w["K"], w["rgb"],
                                w["xyz_map"], est.diameter, 1).numpy()
    ref = np.asarray(jgeometric._icp_refine(je.refiner.cfg, je.mesh_tensors, hyp, w["K"],
                                            w["rgb"], w["xyz_map"], float(je.diameter), 1))
    assert np.linalg.norm(ref[:, :3, 3] - hyp[:, :3, 3], axis=-1).max() > 5e-3  # it moves
    dt = np.abs(out[:, :3, 3] - ref[:, :3, 3]).max(axis=-1)
    dr = _rot_err(out[:, :3, :3], ref[:, :3, :3])
    ok = (dt < 1e-4) & (dr < 1e-3)
    print(f"one ICP iteration, port vs JAX: worst {dt.max():.3g} m / {dr.max():.3g} rad, "
          f"{ok.mean():.3f} of {len(ok)} hypotheses inside the gate")
    assert ok.mean() >= 0.95, (dt.max(), dr.max(), ok.mean())
    assert np.median(dt) < 1e-5 and np.median(dr) < 1e-4


def test_geometric_register_then_track_matches_jax(world):
    """``register`` (4 ICP iterations + 2 on the top 8) then 3 x ``track_one``
    (8 hypotheses, 2 iterations, gate 12). Chained ICP steps cannot be held
    step by step (see the one-iteration test), so the gate is on what a user
    gets: the same best rotation-grid hypothesis, and ADD within 1 % of the
    diameter of the JAX package's pose at every step."""
    est, je, s = world["est"], world["jest"], world["scene"]
    verts = s["mesh"].vertices
    pose = est.register(s["K"], s["rgb"].astype(np.float32), s["depth"], s["mask"])
    ref = je.register(s["K"], s["rgb"].astype(np.float32), s["depth"], s["mask"].astype(np.uint8))
    assert est.hyp_order[0] == je.hyp_order[0]
    assert metrics.add_err(pose, ref, verts) < 0.01 * est.diameter
    assert metrics.adds_err(pose, s["gt"], verts) < 0.1 * est.diameter
    assert est.poses.shape == (126, 4, 4) and np.isfinite(est.scores).all()
    for gt_f, rgb_f, depth_f in demo.motion_frames(s, 3):
        pose = est.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
        ref = je.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
        assert metrics.add_err(pose, ref, verts) < 0.01 * est.diameter
        assert metrics.adds_err(pose, gt_f, verts) < 0.1 * est.diameter


def test_geometric_classes_have_the_port_interface(world):
    """``out_size`` is accepted and ignored (the ICP and the score always run
    at ``cfg.input_size``), the estimator flips ``backface_cull`` on both, and
    ``device=None`` raises without a card."""
    est, w = world["est"], world
    assert est.refiner.cfg.backface_cull and est.scorer.cfg.backface_cull  # watertight mesh
    assert est.refiner.device.type == est.scorer.device.type == "cpu"
    poses = _register_hypotheses(w)[:3]
    args = (est.mesh_tensors, w["rgb"], w["xyz_map"], w["K"], poses, est.diameter)
    a = est.refiner.refine(*args, iteration=1)
    b = est.refiner.refine(*args, iteration=1, out_size=32)
    assert torch.equal(a, b) and a.shape == (3, 4, 4) and a.dtype == torch.float32
    sa, sb = est.scorer.score(*args), est.scorer.score(*args, out_size=32)
    assert torch.equal(sa, sb) and sa.shape == (3,)
    if not torch.cuda.is_available():
        for cls in (geometric.GeometricRefiner, geometric.GeometricScorer):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls()
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.build_estimator(w["scene"]["mesh"], mode="geometric")
    with pytest.raises(ValueError, match="mode"):
        demo.build_estimator(w["scene"]["mesh"], device="cpu", mode="icp")


def test_run_pose_geometric_mode_schedule(monkeypatch, tmp_path):
    """``run_pose --mode geometric`` (the default, as in the JAX CLI) builds the
    geometric estimator with twice the refine iterations and an 8-iteration
    polish and lets ``register`` take its iteration count from the
    configuration; learned mode keeps its own, with the agnostic checkpoint
    and the hybrid scorer."""
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.engine.scorer import HybridScorer
    from foundationpose_tpu_torch.io.file_loader import FileLoader

    seen = {}

    class Stub:
        def __init__(self, mesh, config=None, refiner=None, scorer=None, device=None):
            seen.update(config=config, refiner=refiner, scorer=scorer, device=device)

        def register(self, K, rgb, depth, mask, iteration=None):
            seen["iteration"] = iteration
            return np.eye(4)

        def get_tf_to_centered_mesh(self):
            return np.eye(4)

    monkeypatch.setattr(est_mod, "FoundationPoseTorch", Stub)
    monkeypatch.setattr(FileLoader, "load_rgb_image_from_file",
                        lambda self, p: np.zeros((4, 4, 3), np.uint8))
    monkeypatch.setattr(FileLoader, "load_depth_from_file",
                        lambda self, p: np.ones((4, 4), np.float32))
    monkeypatch.setattr(FileLoader, "load_camera_intrinsics", lambda self, p: np.eye(3))
    monkeypatch.setattr(run_pose, "get_mask", lambda args, rgb, depth: np.ones((4, 4), bool))
    monkeypatch.setattr(meshio, "load_mesh", lambda path: None)
    base = ["--rgb", "a", "--depth", "b", "--intrinsics", "c", "--mesh", "d", "--mask", "e",
            "--device", "cpu", "--out-dir", str(tmp_path), "--debug", "0"]
    run_pose.main(base + ["--est-refine-iter", "3"])
    assert isinstance(seen["refiner"], geometric.GeometricRefiner)
    assert isinstance(seen["scorer"], geometric.GeometricScorer)
    assert seen["iteration"] is None and seen["device"] == torch.device("cpu")
    assert seen["config"].register_iterations == 6
    assert seen["config"].final_refine_iterations == 8
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "pose.txt"), np.eye(4))
    run_pose.main(base + ["--mode", "learned", "--est-refine-iter", "3"])
    assert isinstance(seen["scorer"], HybridScorer) and seen["iteration"] == 3
    assert seen["config"].register_iterations == 3
    assert seen["config"].final_refine_iterations == 2
