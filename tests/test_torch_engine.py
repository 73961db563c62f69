"""The slice as a whole, small: learned-hybrid refine, score, register and
track of the port against the JAX package on one synthetic scene.

Scene: the demo's chiral L-shape over a flat backdrop at 240x320, 126
hypotheses (``min_n_views=12, inplane_step=120``), 64 px crops, float32 nets
on the CPU, both packages loaded from the shipped ``weights/agnostic``
checkpoint. The JAX package runs its plain XLA rasterizer here (its CPU
path), the port its plain PyTorch rasterizer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.engine import estimator as jest
from foundationpose_tpu.engine import geometric as jgeometric
from foundationpose_tpu.engine import refiner as jrefiner_mod
from foundationpose_tpu.engine import scorer as jscorer_mod
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu_torch.apps import demo_synthetic as demo
from foundationpose_tpu_torch.core import geometry as geo, metrics
from foundationpose_tpu_torch.engine import estimator as est_mod
from foundationpose_tpu_torch.engine import geometric, refiner as refiner_mod
from foundationpose_tpu_torch.engine.scorer import HybridScorer, PoseScorer, ScorerConfig
from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
from foundationpose_tpu_torch.models.agnostic import load_agnostic

torch.set_num_threads(1)
PX = 64
WEIGHTS = demo.default_weights_dir()
SCORE_TOL = 2e-3  # see test_register_then_track_matches_jax


@pytest.fixture(scope="module")
def world():
    scene = demo.make_scene((240, 320), device="cpu")
    m = scene["mesh"]
    jmesh = jmeshio.Mesh(m.vertices, m.faces, vertex_colors=m.vertex_colors)

    refiner, scorer, _ = load_agnostic(WEIGHTS, device="cpu", input_size=PX)
    jr_bf16, js_bf16, _ = jagnostic.load_agnostic(WEIGHTS, input_size=PX)
    jrefiner = jrefiner_mod.PoseRefiner(
        dataclasses.replace(jr_bf16.cfg, dtype="float32"), params=jr_bf16.params)
    jscorer = jscorer_mod.PoseScorer(
        dataclasses.replace(js_bf16.cfg, dtype="float32"), params=js_bf16.params)

    cfg = dict(min_n_views=12, inplane_step=120)
    est = est_mod.FoundationPoseTorch(
        m, config=est_mod.EstimatorConfig(**cfg), refiner=refiner,
        scorer=HybridScorer(scorer), device="cpu")
    jestm = jest.FoundationPoseTPU(
        jmesh, config=jest.EstimatorConfig(**cfg), refiner=jrefiner,
        scorer=jscorer_mod.HybridScorer(jscorer))

    # observed inputs exactly as register prepares them (no mask gate here)
    K = scene["K"].astype(np.float32)
    rgb = scene["rgb"].astype(np.float32)
    _, xyz_map = est_mod.preprocess_depth(torch.tensor(scene["depth"]), torch.tensor(K))
    rng = np.random.default_rng(0)
    c = scene["gt"].astype(np.float32) @ np.linalg.inv(est.get_tf_to_centered_mesh()).astype(np.float32)
    poses = np.tile(c[None], (6, 1, 1))
    poses[1:, :3, 3] += rng.normal(0, 0.008, (5, 3)).astype(np.float32)
    dR = geo.so3_exp_map(rng.normal(0, 0.2, (5, 3)).astype(np.float32)).numpy()
    poses[1:, :3, :3] = dR @ poses[1:, :3, :3]
    return dict(scene=scene, est=est, jest=jestm, K=K, rgb=rgb,
                xyz_map=xyz_map.numpy(), poses=poses)


def _rot_err(Ra, Rb):
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.arccos(np.clip((tr - 1) / 2, -1, 1))


def test_setup_agrees(world):
    est, je = world["est"], world["jest"]
    assert est.rot_grid.shape == je.rot_grid.shape == (126, 4, 4)
    np.testing.assert_allclose(est.rot_grid, je.rot_grid, atol=1e-7)
    assert est.diameter == je.diameter and est.watertight == je.watertight
    assert est.refiner.cfg.backface_cull == je.refiner.cfg.backface_cull == est.watertight
    assert est.scorer.geo_cfg.backface_cull == est.watertight
    for k, v in est.mesh_tensors.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(je.mesh_tensors[k]), atol=1e-7)


@pytest.mark.parametrize("gate_px", [0, 12])
def test_refine_once_matches_jax(world, gate_px):
    """One refine step on 6 poses: translation within 1e-4 m, rotation within
    1e-3 rad (float32 nets on crops that agree to ~1e-4, bounded outputs)."""
    est, je, w = world["est"], world["jest"], world
    with torch.no_grad():
        out = refiner_mod.refine_once(
            est.refiner.net, est.mesh_tensors, w["poses"], w["K"], w["rgb"],
            w["xyz_map"], est.diameter, cfg=est.refiner.cfg, gate_px=gate_px).numpy()
    ref = np.asarray(jrefiner_mod.refine_once(
        je.refiner.params, je.mesh_tensors, w["poses"], w["K"], w["rgb"], w["xyz_map"],
        je.diameter, net=je.refiner.net, cfg=je.refiner.cfg, gate_px=gate_px))
    moved = np.linalg.norm(ref[:, :3, 3] - w["poses"][:, :3, 3], axis=-1)
    assert moved.max() > 1e-3  # the step does something
    assert np.abs(out[:, :3, 3] - ref[:, :3, 3]).max() < 1e-4
    assert _rot_err(out[:, :3, :3], ref[:, :3, :3]).max() < 1e-3


@pytest.mark.parametrize("gate_px", [0, 12])
def test_geo_score_matches_jax(world, gate_px):
    est, je, w = world["est"], world["jest"], world
    out = geometric._geo_score(
        est.scorer.geo_cfg, est.mesh_tensors, w["poses"], w["K"], w["rgb"],
        w["xyz_map"], est.diameter, gate_px=gate_px).numpy()
    ref = np.asarray(jgeometric._geo_score(
        je.scorer.geo_cfg, je.mesh_tensors, w["poses"], w["K"], w["rgb"],
        w["xyz_map"], float(je.diameter), gate_px=gate_px))
    assert np.ptp(ref) > 0.05  # the poses are told apart
    # counts of pixels over counts of pixels: a flipped silhouette pixel
    # moves a score by ~1/n_pixels ~ 1e-3; none flips on this scene
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_hybrid_score_matches_jax(world):
    est, je, w = world["est"], world["jest"], world
    out = est.scorer.score(est.mesh_tensors, w["rgb"], w["xyz_map"], w["K"],
                           w["poses"], est.diameter).numpy()
    ref = np.asarray(je.scorer.predict(je.mesh_tensors, w["rgb"], w["xyz_map"], w["K"],
                                       w["poses"], je.diameter))
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert out.argmax() == ref.argmax()


def test_decode_delta_variants_match_jax(world):
    """tracknet without normalisation, deepim translation, 6d rotation."""
    rng = np.random.default_rng(1)
    raw = {"trans": rng.normal(0, 0.3, (6, 3)).astype(np.float32)}
    K, poses = world["K"], world["poses"]
    tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, 0.2, (PX, PX))
    for kw, rot_dim in ((dict(trans_rep="tracknet", normalize_xyz=False), 3),
                        (dict(trans_rep="deepim"), 3),
                        (dict(rot_rep="6d"), 6)):
        raw["rot"] = rng.normal(0, 0.5, (6, rot_dim)).astype(np.float32)
        t, R = refiner_mod.decode_delta(
            {k: torch.tensor(v) for k, v in raw.items()}, RefinerConfig(input_size=PX, **kw),
            0.2, poses=torch.tensor(poses), K=torch.tensor(K), tf_to_crops=tfs, input_size=PX)
        jt, jR = jrefiner_mod.decode_delta(
            raw, jrefiner_mod.RefinerConfig(input_size=PX, **kw), 0.2, poses=poses, K=K,
            tf_to_crops=tfs.numpy(), input_size=PX)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-5)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)


def _scores_by_hypothesis(e):
    out = np.empty(len(e.scores), np.float64)
    out[np.asarray(e.hyp_order)] = e.scores
    return out


def test_register_then_track_matches_jax(world):
    """register (2 iterations + the default 2-iteration polish of the top 8)
    then 2 x track_one (8 hypotheses, gate 12). Both packages pad the 126
    hypotheses to 128 with copies of hypothesis 0, so the comparison is made
    score by score: the same best hypothesis, the same eight polished
    hypotheses, and the scores of all 126 real hypotheses within SCORE_TOL
    (float32 nets on crops that agree to ~1e-4, through two refine steps and
    a score that counts pixels: one flipped silhouette pixel moves the
    geometric term by ~1e-3 and the hybrid weighs it twice; the largest
    difference seen on this scene is 4.9e-4). Poses: ADD within
    1 % of the diameter of the JAX package's pose at every step. (How close
    either lands to the ground truth at this cut-down size — 64 px crops,
    2 iterations — is not the point here; the full-size accuracy gate is in
    chip_smoke.py.)"""
    est, je, s = world["est"], world["jest"], world["scene"]
    verts = s["mesh"].vertices
    rgb = s["rgb"].astype(np.float32)
    pose = est.register(s["K"], rgb, s["depth"], s["mask"], iteration=2)
    ref = je.register(s["K"], rgb, s["depth"], s["mask"].astype(np.uint8), iteration=2)
    assert est.hyp_order[0] == je.hyp_order[0]
    assert set(est.hyp_order[:8]) == set(je.hyp_order[:8])
    mine, theirs = _scores_by_hypothesis(est), _scores_by_hypothesis(je)
    assert np.isfinite(theirs).all() and np.ptp(theirs[je.hyp_order[8:]]) > 1.0
    np.testing.assert_allclose(mine, theirs, atol=SCORE_TOL, rtol=0)
    assert metrics.add_err(pose, ref, verts) < 0.01 * est.diameter
    assert est.poses.shape == (126, 4, 4) and np.isfinite(est.scores).all()
    assert (np.diff(est.scores) <= 0).all() and est.scores[7] > 50 > est.scores[8]
    assert metrics.adds_err(pose, s["gt"], verts) < 0.25 * est.diameter  # same basin
    for _, rgb_f, depth_f in demo.motion_frames(s, 2):
        pose = est.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
        ref = je.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
        assert metrics.add_err(pose, ref, verts) < 0.01 * est.diameter


def test_register_pads_hypotheses_to_the_bucket(world, monkeypatch):
    """126 hypotheses are refined and scored as 128 (two copies of hypothesis
    0 at the tail, as in the JAX package); pads never win, never take a
    polish slot and never appear in what register returns."""
    est, s = world["est"], world["scene"]
    seen = {"refine": [], "score": []}
    refine, score = est.refiner.refine, est.scorer.score

    def spy_refine(mt, rgb, xyz, K, poses, *a, **kw):
        seen["refine"].append(poses.clone())
        return refine(mt, rgb, xyz, K, poses, *a, **kw)

    def spy_score(mt, rgb, xyz, K, poses, *a, **kw):
        seen["score"].append(len(poses))
        return score(mt, rgb, xyz, K, poses, *a, **kw)

    monkeypatch.setattr(est.refiner, "refine", spy_refine)
    monkeypatch.setattr(est.scorer, "score", spy_score)
    est.register(s["K"], s["rgb"], s["depth"], s["mask"], iteration=1)
    assert est.rot_grid.shape[0] == 126 and est_mod.HYP_BUCKET == 32
    assert [len(p) for p in seen["refine"]] == [128, 8] and seen["score"] == [128, 8]
    first = seen["refine"][0]
    assert torch.equal(first[126:], first[:1].expand(2, 4, 4))  # copies of hypothesis 0
    assert est.poses.shape == (126, 4, 4) and est.scores.shape == (126,)
    assert sorted(est.hyp_order.tolist()) == list(range(126))  # no pad index, none lost
    assert np.isfinite(est.scores).all() and (np.diff(est.scores) <= 0).all()
    assert (est.scores[:8] > 50).all() and (est.scores[8:] < 50).all()


def test_single_hypothesis_tracking_is_ungated_like_jax(world):
    """With ``track_hypotheses=1`` the JAX package does not pass its gate to
    the refine-only program; the port mirrors that."""
    est, je, s = world["est"], world["jest"], world["scene"]
    start = np.asarray(je.pose_last if je.pose_last is not None else
                       s["gt"] @ np.linalg.inv(je.get_tf_to_centered_mesh()))
    gt_f, rgb_f, depth_f = next(demo.motion_frames(s, 1))
    old = est.cfg.track_hypotheses, je.cfg.track_hypotheses
    try:
        est.cfg.track_hypotheses = je.cfg.track_hypotheses = 1
        est.pose_last = start.copy()
        je.pose_last = start.copy()
        pose = est.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
        ref = je.track_one(rgb_f.astype(np.float32), depth_f, s["K"])
    finally:
        est.cfg.track_hypotheses, je.cfg.track_hypotheses = old
    assert metrics.add_err(pose, ref, s["mesh"].vertices) < 0.01 * est.diameter


def test_depth_rounding_of_tracking_is_mirrored():
    """track_one rounds depth to the 0.25 mm steps the JAX package sends."""
    d = np.array([[0.50012, 0.0, 1.23456]], np.float32)
    q = (np.clip(d, 0, None) * (1.0 / 0.00025) + 0.5).astype(np.uint16)
    back = q.astype(np.float32) * np.float32(0.00025)
    assert np.abs(back - d).max() <= 0.000125 + 1e-7 and back[0, 1] == 0


def test_guess_translation_exact_median():
    rng = np.random.default_rng(3)
    K = np.array([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]], np.float32)
    for n_holes in (0, 1):  # odd and even counts of valid pixels
        depth = rng.uniform(0.4, 0.9, (240, 320)).astype(np.float32)
        mask = np.zeros((240, 320), bool)
        mask[100:131, 140:181] = True
        depth[100, 140:140 + n_holes] = 0.0
        c, n = est_mod.guess_translation(torch.tensor(depth), torch.tensor(mask), torch.tensor(K))
        jc, jn = jest._guess_translation_traced(depth, mask.astype(np.uint8), K)
        assert n == int(jn) == 31 * 41 - n_holes
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        assert abs(c[2].item() - np.median(depth[mask & (depth >= 0.001)])) < 1e-6
    c, n = est_mod.guess_translation(torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.bool),
                                     torch.tensor(K))
    assert n == 0 and (c == 0).all()


def test_register_translation_only_fallback(world):
    est, s = world["est"], world["scene"]
    tiny = np.zeros_like(s["mask"])
    tiny[120, 160] = True
    pose = est.register(s["K"], s["rgb"], s["depth"], tiny)
    assert np.allclose(pose[:3, :3], np.eye(3)) and pose[2, 3] > 0


def test_device_rule_and_unported_settings(world):
    """``device=None`` raises without a card; what is still to be ported
    (``device_mesh``, debug dumps, ``--weights``) is refused; the funnel
    settings, ``sync=False`` and ``--mode geometric``, refused by the first
    slices of the port, are accepted now."""
    mesh = world["scene"]["mesh"]
    if not torch.cuda.is_available():
        for make in (lambda: PoseRefiner(RefinerConfig()), lambda: PoseScorer(ScorerConfig()),
                     lambda: load_agnostic(WEIGHTS), lambda: demo.make_scene(),
                     lambda: est_mod.FoundationPoseTorch(mesh)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    E = est_mod.EstimatorConfig
    parts = dict(refiner=world["est"].refiner, scorer=world["est"].scorer, device="cpu")
    with pytest.raises(NotImplementedError):
        est_mod.FoundationPoseTorch(mesh, config=E(debug=1), **parts)
    with pytest.raises(NotImplementedError):
        est_mod.FoundationPoseTorch(mesh, device_mesh=object(), **parts)
    for cfg in (E(funnel_top_k=16), E(funnel_coarse_size=112), E(funnel_coarse_faces=512)):
        funnel = est_mod.FoundationPoseTorch(mesh, config=cfg, **parts)
        # 36 faces are under any face budget here: the coarse tensors are a
        # second, equal set only when a budget is set
        assert (funnel.mesh_tensors_coarse is funnel.mesh_tensors) == (cfg.funnel_coarse_faces == 0)
    from foundationpose_tpu_torch.apps import run_pose

    base = ["--rgb", "a", "--depth", "b", "--intrinsics", "c", "--mesh", "d", "--mask", "e"]
    with pytest.raises(NotImplementedError):
        run_pose.main(base + ["--weights", "w"])
    with pytest.raises(FileNotFoundError):  # geometric mode is taken; the files are missing
        run_pose.main(base + ["--mode", "geometric", "--device", "cpu"])
    fresh = est_mod.FoundationPoseTorch(
        mesh, config=E(min_n_views=12, inplane_step=120), **parts)
    for sync in (True, False):
        with pytest.raises(RuntimeError, match="register"):
            fresh.track_one(world["scene"]["rgb"], world["scene"]["depth"],
                            world["scene"]["K"], sync=sync)


def test_streaming_track_equals_sync(world):
    """``track_one(sync=False)`` frame by frame against ``sync=True`` from the
    same start pose: the returned (4,4) device tensor, and ``pose_last`` after
    the last frame, within 1e-5 (the same float32 computation; on the CPU they
    are the same numbers). The chain stays on the device between frames, the
    pre-crop window is placed from the last pose that has landed on the host,
    and setting ``pose_last`` resets the chain."""
    est, s = world["est"], world["scene"]
    start = s["gt"] @ np.linalg.inv(est.get_tf_to_centered_mesh())
    frames = [(rgb.astype(np.float32), depth) for _, rgb, depth in demo.motion_frames(s, 3)]

    est.pose_last = start
    assert est._pose_last_dev is None and est._pending is None
    synced = [est.track_one(rgb, depth, s["K"]) for rgb, depth in frames]
    last_synced = est.pose_last.copy()
    assert synced[0].dtype == np.float64 and est._pose_last_dev is not None

    est.pose_last = start  # resets the chain
    assert est._pose_last_dev is None and np.array_equal(est.pose_last, start)
    for i, (rgb, depth) in enumerate(frames):
        out = est.track_one(rgb, depth, s["K"], sync=False)
        assert isinstance(out, torch.Tensor) and out.shape == (4, 4)
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        # the chain is on the device only; the download waits to be picked up
        assert est._pose_last_np is None and est._pending is not None
        np.testing.assert_allclose(out.numpy(), synced[i], atol=1e-5)
        if i == 1:
            # the hint that placed this frame's window was frame 0's pose, landed
            np.testing.assert_allclose(
                est._pose_hint @ est.get_tf_to_centered_mesh(), synced[0], atol=1e-5)
    np.testing.assert_allclose(est.pose_last, last_synced, atol=1e-5)
    assert est.pose_last.dtype == np.float64
    assert np.abs(last_synced[:3, 3] - start[:3, 3]).max() > 5e-3  # the object did move

    # a mixed sequence continues the same chain
    again = est.track_one(*frames[2], s["K"], sync=True)
    est.pose_last = last_synced
    np.testing.assert_allclose(est.track_one(*frames[2], s["K"]), again, atol=1e-5)


def test_upload_helper_copies_and_converts():
    """The one upload path of ``register`` and ``track_one``: on the CPU a
    copy (never an alias of the caller's array), converted on the host."""
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = est_mod._upload(a, torch.device("cpu"), torch.float32)
    assert t.dtype == torch.float32 and t.shape == (2, 3)
    a[0, 0] = 99.0
    assert t[0, 0] == 0.0
    m = est_mod._upload(np.array([[True, False]])[:, ::-1], torch.device("cpu"))
    assert m.dtype == torch.bool and m.tolist() == [[False, True]]
    d = est_mod._PoseDownload(torch.eye(4))
    assert d.ready() and d.numpy().dtype == np.float64
