"""The port's Schur-complement bundle adjustment (foundationpose_tpu_torch/slam/ba.py)
against the JAX package's, and the six checks of tests/test_ba.py through the
port (the sharded one runs in two processes: tests/test_torch_parallel.py).

Inputs are numpy arrays made from a seed and fed to both packages. One GN
iteration is held at atol 5e-5 (the JAX test's own tolerance for the Schur
step, tests/test_ba.py:144-145): the einsums sum in another order than XLA's.
The host problem builder is the same numpy code and is held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.slam import ba as jba
from foundationpose_tpu_torch.core import geometry as geo, meshio, poses as poses_mod
from foundationpose_tpu_torch.ops import raster
from foundationpose_tpu_torch.parallel.mesh import make_device_mesh
from foundationpose_tpu_torch.slam import ba

ATOL = 5e-5


def rot(ai, aj, ak):
    return poses_mod.euler_matrix_np(ai, aj, ak)[:3, :3]


def make_problem(K_poses=5, L=60, noise=0.0, pose_err=0.0, seed=0):
    """Cameras on an arc looking at landmarks near the origin (the problem
    of tests/test_ba.py, with float64 rotations)."""
    rng = np.random.default_rng(seed)
    X_gt = rng.uniform(-0.1, 0.1, size=(L, 3))
    poses_gt = np.tile(np.eye(4), (K_poses, 1, 1))
    for k in range(K_poses):
        poses_gt[k, :3, :3] = rot(0.0, 0.25 * (k - K_poses / 2), 0.0)
        poses_gt[k, :3, 3] = [0.02 * k, -0.01 * k, 0.6]
    obs_kf = np.tile(np.arange(K_poses, dtype=np.int32)[None], (L, 1))
    pts = np.einsum("kij,lj->lki", poses_gt[:, :3, :3], X_gt) + poses_gt[:, :3, 3][None]
    obs_pt = pts + rng.normal(0, noise, size=pts.shape)
    obs_w = np.ones((L, K_poses), np.float32)
    poses_init = poses_gt.copy()
    if pose_err > 0:
        for k in range(1, K_poses):
            d = np.eye(4)
            d[:3, :3] = rot(*rng.normal(0, pose_err, 3))
            d[:3, 3] = rng.normal(0, pose_err * 0.1, 3)
            poses_init[k] = d @ poses_gt[k]
    X_init = X_gt + rng.normal(0, pose_err * 0.05, size=X_gt.shape)
    return poses_gt, X_gt, poses_init, X_init, obs_kf, obs_pt.astype(np.float32), obs_w


def random_normals(shape, seed):
    """Unit normals with every third observation left without one."""
    n = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, ::3] = 0.0
    return n


def geodesic(R1, R2):
    return float(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("prior", [0.0, 0.5])
def test_one_iteration_matches_jax(normals, prior):
    _, _, poses, X, kf, pt, w = make_problem(pose_err=0.05, seed=2)
    obs_n = random_normals(pt.shape, 7) if normals else None
    fixed = np.zeros(len(poses), bool)
    fixed[0] = True
    init = poses.copy()
    init[1:, :3, 3] += 0.003  # a prior residual that is not zero
    ref = jba._ba_iteration(
        jnp.asarray(poses, jnp.float32), jnp.asarray(X, jnp.float32), jnp.asarray(kf),
        jnp.asarray(pt), jnp.asarray(w), None if obs_n is None else jnp.asarray(obs_n),
        jnp.asarray(fixed), jnp.float32(1e-3), jnp.asarray(init, jnp.float32),
        cfg=jba.BAConfig(pose_prior=prior))
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    out = ba._ba_iteration(
        t(poses), t(X), torch.tensor(kf).long(), t(pt), t(w),
        None if obs_n is None else t(obs_n), torch.tensor(fixed), torch.tensor(1e-3), t(init),
        ba.BAConfig(pose_prior=prior))
    for name, a, b in zip(("poses", "X", "cost", "cost_new"), ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("normals", [False, True])
def test_bundle_adjust_matches_jax(normals):
    """The whole LM loop: the same accept / reject sequence (costs), the same
    final poses and landmarks."""
    _, _, poses, X, kf, pt, w = make_problem(pose_err=0.05, seed=4)
    obs_n = random_normals(pt.shape, 8) if normals else None
    cfg = dict(n_iters=6, scale=0.02)
    pj, xj, cj = jba.bundle_adjust(poses, X, kf, pt, w, obs_n=obs_n, config=jba.BAConfig(**cfg))
    p, x, c = ba.bundle_adjust(poses, X, kf, pt, w, obs_n=obs_n, config=ba.BAConfig(**cfg),
                               device="cpu")
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-9)


def test_zero_residual_is_fixed_point():
    poses_gt, X_gt, *_, obs_kf, obs_pt, obs_w = make_problem()
    poses, X, costs = ba.bundle_adjust(poses_gt, X_gt, obs_kf, obs_pt, obs_w,
                                       config=ba.BAConfig(n_iters=2), device="cpu")
    np.testing.assert_allclose(poses.numpy(), poses_gt, atol=1e-5)
    np.testing.assert_allclose(X.numpy(), X_gt, atol=1e-5)
    assert float(costs[-1]) < 1e-8


def test_recovers_perturbed_poses():
    poses_gt, X_gt, poses_init, X_init, obs_kf, obs_pt, obs_w = make_problem(pose_err=0.08, seed=1)
    poses, X, costs = ba.bundle_adjust(poses_init, X_init, obs_kf, obs_pt, obs_w,
                                       config=ba.BAConfig(n_iters=10, scale=0.05), device="cpu")
    poses = poses.numpy()
    # pose 0 pinned: the others align to the truth in its gauge
    terr = np.linalg.norm(poses[:, :3, 3] - poses_gt[:, :3, 3], axis=1).max()
    # float32, as the JAX test measures it
    rerr = float(geo.rotation_geodesic_distance(poses[:, :3, :3], poses_gt[:, :3, :3]).max())
    assert terr < 1e-4 and rerr < 1e-4, (terr, rerr)
    assert float(costs[-1]) < float(costs[0]) * 1e-3
    np.testing.assert_allclose(X.numpy(), X_gt, atol=1e-4)


def test_gauge_pose_fixed():
    _, _, poses_init, X_init, obs_kf, obs_pt, obs_w = make_problem(pose_err=0.05, seed=2)
    poses, _, _ = ba.bundle_adjust(poses_init, X_init, obs_kf, obs_pt, obs_w,
                                   config=ba.BAConfig(n_iters=4), device="cpu")
    np.testing.assert_allclose(poses.numpy()[0], poses_init[0], atol=1e-6)


def test_schur_matches_dense_solve():
    """The Schur-reduced update equals solving the full (6K+3L) normal
    equations directly (float64 numpy)."""
    _, _, poses_init, X_init, obs_kf, obs_pt, obs_w = make_problem(K_poses=3, L=8, pose_err=0.03,
                                                                   seed=3)
    cfg = ba.BAConfig(n_iters=1, damping=0.0, huber_delta_rel=1e9)  # pure GN, not robust
    poses1, X1, _ = ba.bundle_adjust(poses_init, X_init, obs_kf, obs_pt, obs_w, config=cfg,
                                     device="cpu")
    Kp, L = 3, 8
    R, t = poses_init[:, :3, :3], poses_init[:, :3, 3]
    H = np.zeros((6 * Kp + 3 * L, 6 * Kp + 3 * L))
    g = np.zeros(6 * Kp + 3 * L)
    for l in range(L):
        for m in range(Kp):
            k = obs_kf[l, m]
            p = R[k] @ X_init[l] + t[k]
            r = p - obs_pt[l, m]
            skew = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
            Jp = np.concatenate([-skew, np.eye(3)], axis=1)
            Jl = R[k]
            ip = slice(6 * k, 6 * k + 6)
            il = slice(6 * Kp + 3 * l, 6 * Kp + 3 * l + 3)
            H[ip, ip] += Jp.T @ Jp
            H[il, il] += Jl.T @ Jl
            H[ip, il] += Jp.T @ Jl
            H[il, ip] += Jl.T @ Jp
            g[ip] -= Jp.T @ r
            g[il] -= Jl.T @ r
    free = np.ones(6 * Kp + 3 * L)
    free[:6] = 0.0  # pose 0 pinned
    H = H * free[:, None] * free[None, :] + np.diag(1.0 - free)
    g = g * free
    H += 1e-9 * np.eye(len(H))
    for l in range(L):
        il = slice(6 * Kp + 3 * l, 6 * Kp + 3 * l + 3)
        H[il, il] += 1e-9 * np.eye(3)
    delta = np.linalg.solve(H, g)
    dxi = delta[: 6 * Kp].reshape(Kp, 6)
    tw = np.concatenate([dxi[:, 3:], dxi[:, :3]], axis=-1)
    poses_ref = geo.se3_exp_map(torch.tensor(tw, dtype=torch.float32)).numpy() @ poses_init
    np.testing.assert_allclose(poses1.numpy(), poses_ref, atol=5e-5)
    np.testing.assert_allclose(X1.numpy(), X_init + delta[6 * Kp:].reshape(L, 3), atol=5e-5)


def test_one_process_mesh_equals_the_unsharded_run():
    """The sharded code path on a one-process mesh (no pad, identity
    collectives) gives the unsharded run's bits."""
    _, _, poses, X, kf, pt, w = make_problem(K_poses=4, L=50, pose_err=0.05, seed=4)
    cfg = ba.BAConfig(n_iters=5)
    a = ba.bundle_adjust(poses, X, kf, pt, w, config=cfg, device="cpu")
    b = ba.bundle_adjust(poses, X, kf, pt, w, config=cfg, mesh=make_device_mesh(device="cpu"))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def l_shape_keyframes(F=5, hw=(128, 160)):
    """Depth keyframes of the chiral L-shape (tests/test_ba.py's end-to-end
    scene) through the port's plain rasterizer, and the noisy camera poses."""
    K = np.array([[300.0, 0, 80], [0, 300.0, 64], [0, 0, 1]])
    a = meshio.make_box((0.12, 0.04, 0.04))
    b = meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0])
    c = meshio.make_box((0.04, 0.04, 0.07)).translated([-0.04, 0.0, 0.055])
    verts = np.concatenate([m.vertices for m in (a, b, c)])
    offs = np.cumsum([0, len(a.vertices), len(b.vertices)])
    faces = np.concatenate([m.faces + o for m, o in zip((a, b, c), offs)])
    mt = raster.make_mesh_tensors(meshio.Mesh(verts, faces), device="cpu")
    rng = np.random.default_rng(5)
    cams, depths, masks = [], [], []
    for f in range(F):
        ob_in_cam = np.eye(4)
        ob_in_cam[:3, :3] = rot(0.5 + 0.25 * f, -0.3 - 0.1 * f, 0.1)
        ob_in_cam[:3, 3] = [0.01 * f, -0.005 * f, 0.5]
        out = raster.render_full_frame(mt, ob_in_cam[None].astype(np.float32), K, hw)
        depths.append(out["depth"][0].numpy())
        masks.append(out["mask"][0].numpy())
        cams.append(np.linalg.inv(ob_in_cam))
    cams_gt = np.stack(cams)
    cams_noisy = cams_gt.copy()
    for f in range(1, F):
        d = np.eye(4)
        d[:3, :3] = rot(*rng.normal(0, 0.02, 3))
        d[:3, 3] = rng.normal(0, 0.004, 3)
        cams_noisy[f] = cams_gt[f] @ d
    return K, np.stack(depths), np.stack(masks), cams_gt, cams_noisy


@pytest.fixture(scope="module")
def keyframes():
    return l_shape_keyframes()


def test_build_ba_problem_bit_for_bit(keyframes):
    K, depths, masks, _, cams = keyframes
    np.testing.assert_array_equal(ba._normal_maps(depths, K), jba._normal_maps(depths, K))
    mine = ba.build_ba_problem(depths, masks, cams, K, n_landmarks=384, seed=3)
    ref = jba.build_ba_problem(depths, masks, cams, K, n_landmarks=384, seed=3)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    assert (mine["obs_w"] > 0).sum(axis=1).mean() > 2  # landmarks seen in several frames


def test_end_to_end_projective_association(keyframes):
    """Perturbed keyframe poses of the L-shape: pose-graph BA halves the mean
    rotation error without doubling the translation error (the gate of
    tests/test_ba.py:229-230). Its first round lands where the JAX package's
    does on the same depth maps; later rounds re-associate landmarks through
    hard thresholds (mask, 15 mm depth agreement, normal agreement), so a
    float32 difference of 1e-6 in round 1 redraws part of round 2's problem
    (up to 0.8 mm apart on this scene), and they are held by the gate."""
    K, depths, masks, cams_gt, cams_noisy = keyframes

    def pose_err(cams):
        te = np.linalg.norm(cams[:, :3, 3] - cams_gt[:, :3, 3], axis=1).mean()
        re = np.mean([geodesic(c[:3, :3], g[:3, :3]) for c, g in zip(cams, cams_gt)])
        return te, re

    te0, re0 = pose_err(cams_noisy)
    cfg = dict(n_iters=8, scale=0.01)
    refined, cost = ba.pose_graph_ba(depths, masks, cams_noisy, K, n_landmarks=384,
                                     config=ba.BAConfig(**cfg), rounds=4, device="cpu")
    te1, re1 = pose_err(refined)
    assert re1 < 0.5 * re0, (re0, re1)
    assert te1 < 2.0 * te0, (te0, te1)
    one, cost1 = ba.pose_graph_ba(depths, masks, cams_noisy, K, n_landmarks=384,
                                  config=ba.BAConfig(**cfg), rounds=1, device="cpu")
    ref, ref_cost = jba.pose_graph_ba(depths, masks, cams_noisy, K, n_landmarks=384,
                                      config=jba.BAConfig(**cfg), rounds=1)
    np.testing.assert_allclose(one, ref, atol=1e-5)
    np.testing.assert_allclose(cost1, ref_cost, rtol=1e-5)
