"""The funnel schedule of ``register`` (coarse pass over all hypotheses, then
the remaining iterations on the top K; optionally a decimated mesh and a
smaller crop size for the coarse pass) against the JAX package's funnel with
the same configuration — never against the port's own full schedule, whose
comparison with the funnel depends on the scene.

Small size: 240x320 frames, 126 hypotheses padded to 128, 64 px crops (48 px
coarse), top 16, float32 on the CPU, plain rasterizers on both sides. The
learned-hybrid cases use randomly initialised nets carried across from flax
with ``models/convert.flax_params_to_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.engine import estimator as jest
from foundationpose_tpu.engine import geometric as jgeometric
from foundationpose_tpu.engine import refiner as jrefiner_mod
from foundationpose_tpu.engine import scorer as jscorer_mod
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet
from foundationpose_tpu.models.score_net import ScoreNetMultiPair as JScoreNet
from foundationpose_tpu_torch.apps import demo_synthetic as demo
from foundationpose_tpu_torch.core import meshio, metrics
from foundationpose_tpu_torch.engine import estimator as est_mod
from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
from foundationpose_tpu_torch.engine.scorer import HybridScorer, PoseScorer, ScorerConfig
from foundationpose_tpu_torch.models import convert
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair
from foundationpose_tpu_torch.ops import raster

torch.set_num_threads(1)
PX, TOP_K = 64, 16
NEAR_KTH = 2e-3  # see test_funnel_register_matches_jax_funnel


def _carry(jparams, net, tmp_path, name):
    path = str(tmp_path / f"{name}.npz")
    jagnostic.save_params_npz(path, jparams, dtype=None)
    convert.load_flax_npz(path, net)


def _blob_mesh():
    """An asymmetric 320-face closed mesh (a bent, tapered ellipsoid) with
    position-dependent vertex colours: enough faces for a coarse LOD, no
    symmetry that would make the best hypothesis ambiguous."""
    m = meshio.make_icosphere_mesh(subdivisions=2, radius=1.0)
    v = m.vertices.copy()
    taper = 1.0 + 0.35 * v[:, 0]
    v = np.stack([0.07 * v[:, 0] + 0.02 * v[:, 1] ** 2, 0.045 * v[:, 1] * taper,
                  0.03 * v[:, 2] * taper + 0.015 * v[:, 0] * v[:, 1]], axis=-1)
    mesh = meshio.Mesh(v, m.faces)
    mesh.vertex_colors = np.clip(128 + 1500 * v, 0, 255).astype(np.uint8)
    return mesh


def _scene(mesh):
    hw = (240, 320)
    K, gt = demo.default_intrinsics(hw), demo.default_gt_pose()
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    rgb, depth, mask = demo.render_frame(mt, gt, K, hw)
    return dict(mesh=mesh, K=K, gt=gt, rgb=rgb.astype(np.float32), depth=depth, mask=mask)


def _learned_pair(tmp_path):
    """(port refiner, port hybrid scorer, JAX refiner, JAX hybrid scorer)
    with the same random float32 parameters."""
    jr = jrefiner_mod.PoseRefiner(
        jrefiner_mod.RefinerConfig(input_size=PX, dtype="float32", use_pallas=False), seed=5)
    js = jscorer_mod.PoseScorer(
        jscorer_mod.ScorerConfig(input_size=PX, dtype="float32", use_pallas=False), seed=6)
    refiner = PoseRefiner(RefinerConfig(input_size=PX, dtype="float32"), device="cpu")
    scorer = PoseScorer(ScorerConfig(input_size=PX, dtype="float32"), device="cpu")
    _carry(jr.params, refiner.net, tmp_path, "refiner")
    _carry(js.params, scorer.net, tmp_path, "scorer")
    return refiner, HybridScorer(scorer), jr, jscorer_mod.HybridScorer(js)


def _geometric_pair(tmp_path):
    from foundationpose_tpu_torch.engine import geometric

    g = geometric.GeometricConfig(input_size=PX)
    jg = jgeometric.GeometricConfig(input_size=PX)
    return (geometric.GeometricRefiner(g, "cpu"), geometric.GeometricScorer(g, "cpu"),
            jgeometric.GeometricRefiner(jg), jgeometric.GeometricScorer(jg))


CASES = {
    # name: (mesh, refiner/scorer pair, funnel settings, register iterations)
    "learned_hybrid": (demo.make_l_shape, _learned_pair, {}, 3),
    "learned_hybrid_coarse_size_and_lod": (
        _blob_mesh, _learned_pair, dict(funnel_coarse_size=48, funnel_coarse_faces=96), 3),
    "geometric": (demo.make_l_shape, _geometric_pair, {}, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_funnel_register_matches_jax_funnel(case, tmp_path, monkeypatch):
    """Same funnel configuration in both packages. Gates:

    - the 16 survivors of the coarse pass are the same, except hypotheses
      whose coarse score lies within 2e-3 of the 16th: the packages' scores
      differ by up to ~1.4e-3 here (float32 nets with random weights and pixel
      counts on crops that agree to ~1e-4), so membership is only decided
      where the margin is larger than that;
    - the same best hypothesis, and a final pose within 1 % of the diameter
      (ADD) of the JAX package's — the register gate of the full schedule;
    - pads never reach the top K (neither the funnel's nor the polish's), and
      the coarse pass really ran on the coarse mesh at the coarse size."""
    make_mesh, make_pair, funnel, iteration = CASES[case]
    mesh = make_mesh()
    s = _scene(mesh)
    refiner, scorer, jrefiner, jscorer = make_pair(tmp_path)
    cfg = dict(min_n_views=12, inplane_step=120, funnel_top_k=TOP_K,
               funnel_coarse_iterations=1, **funnel)
    est = est_mod.FoundationPoseTorch(mesh, config=est_mod.EstimatorConfig(**cfg),
                                      refiner=refiner, scorer=scorer, device="cpu")
    je = jest.FoundationPoseTPU(
        jmeshio.Mesh(mesh.vertices, mesh.faces, vertex_colors=mesh.vertex_colors),
        config=jest.EstimatorConfig(**cfg), refiner=jrefiner, scorer=jscorer)
    lod = bool(funnel.get("funnel_coarse_faces"))
    assert (est.mesh_tensors_coarse is not est.mesh_tensors) == lod
    for k, v in est.mesh_tensors_coarse.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(je.mesh_tensors_coarse[k]), atol=1e-7)
    if lod:
        assert est.mesh_tensors_coarse["faces"].shape[0] < est.mesh_tensors["faces"].shape[0]

    calls = {"refine": [], "score": [], "top_k": []}
    refine, score, top_k = est.refiner.refine, est.scorer.score, est._top_k

    def spy_refine(mt, rgb, xyz, K, poses, diam, it, out_size=None, **kw):
        calls["refine"].append((mt is est.mesh_tensors_coarse, len(poses), it, out_size))
        return refine(mt, rgb, xyz, K, poses, diam, it, out_size=out_size, **kw)

    def spy_score(mt, rgb, xyz, K, poses, diam, out_size=None, **kw):
        out = score(mt, rgb, xyz, K, poses, diam, out_size=out_size, **kw)
        calls["score"].append((mt is est.mesh_tensors_coarse, out_size, out.clone()))
        return out

    def spy_top_k(scores, k):
        idx = top_k(scores, k)
        calls["top_k"].append(idx.numpy())
        return idx

    monkeypatch.setattr(est.refiner, "refine", spy_refine)
    monkeypatch.setattr(est.scorer, "score", spy_score)
    monkeypatch.setattr(est, "_top_k", spy_top_k)
    pose = est.register(s["K"], s["rgb"], s["depth"], s["mask"], iteration=iteration)
    ref = je.register(s["K"], s["rgb"], s["depth"], s["mask"].astype(np.uint8),
                      iteration=iteration)

    # the schedule: coarse over all 128, fine on 16, polish on 8
    size = funnel.get("funnel_coarse_size") or None
    # (first entry: the call was given the coarse tensors — the same dict as
    # the full ones unless a face budget is set)
    assert calls["refine"] == [(True, 128, 1, size),
                               (not lod, TOP_K, iteration - 1, None),
                               (not lod, 8, 2, None)]
    assert [(c[0], c[1]) for c in calls["score"]] == [
        (True, size), (not lod, None), (not lod, None)]
    survivors, polished = calls["top_k"]
    assert len(survivors) == TOP_K and (survivors < 126).all() and (polished < 126).all()
    assert sorted(est.hyp_order.tolist()) == list(range(126))  # no pad, none lost

    # survivors: every hypothesis rescored by the fine pass carries the +100
    mine = set(est.hyp_order[est.scores > 50].tolist())
    theirs = set(np.asarray(je.hyp_order)[np.asarray(je.scores) > 50].tolist())
    assert mine == set(survivors.tolist()) and len(theirs) == TOP_K
    coarse = calls["score"][0][2].numpy()[:126]
    kth = np.sort(coarse)[-TOP_K]
    for h in mine ^ theirs:
        assert abs(coarse[h] - kth) <= NEAR_KTH, (h, coarse[h], kth)
    # where the JAX package still holds a coarse score (its non-survivors)
    jax_coarse = np.full(126, np.nan)
    kept = np.asarray(je.scores) < 50
    jax_coarse[np.asarray(je.hyp_order)[kept]] = np.asarray(je.scores)[kept]
    print(f"funnel {case}: survivors differing {sorted(mine ^ theirs)}, coarse scores "
          f"within {np.nanmax(np.abs(jax_coarse - coarse)):.3g} of the JAX package's, final "
          f"ADD {metrics.add_err(pose, ref, mesh.vertices) / est.diameter:.3g} of the diameter")
    assert np.ptp(coarse) > 20 * NEAR_KTH  # the coarse scores do tell hypotheses apart

    assert est.hyp_order[0] == je.hyp_order[0]
    assert metrics.add_err(pose, ref, mesh.vertices) < 0.01 * est.diameter
    assert np.isfinite(est.scores).all() and (np.diff(est.scores) <= 0).all()


@pytest.mark.parametrize("iteration,top_k", [(1, TOP_K), (3, 0), (3, 128)])
def test_funnel_conditions_fall_back_to_the_full_schedule(iteration, top_k, monkeypatch):
    """As in the JAX package the funnel runs only when ``0 < funnel_top_k <
    padded hypothesis count`` and at least one iteration is left for the fine
    pass; otherwise every hypothesis gets every iteration."""
    from foundationpose_tpu_torch.engine import geometric

    mesh = demo.make_l_shape()
    s = _scene(mesh)
    g = geometric.GeometricConfig(input_size=32)
    est = est_mod.FoundationPoseTorch(
        mesh, config=est_mod.EstimatorConfig(min_n_views=12, inplane_step=120,
                                             funnel_top_k=top_k, final_refine_iterations=0),
        refiner=geometric.GeometricRefiner(g, "cpu"), scorer=geometric.GeometricScorer(g, "cpu"),
        device="cpu")
    seen = []
    refine = est.refiner.refine

    def spy(mt, rgb, xyz, K, poses, diam, it, **kw):
        seen.append((len(poses), it))
        return refine(mt, rgb, xyz, K, poses, diam, it, **kw)

    monkeypatch.setattr(est.refiner, "refine", spy)
    est.register(s["K"], s["rgb"], s["depth"], s["mask"], iteration=iteration)
    assert seen == [(128, iteration)]


@pytest.mark.parametrize("net", ["refine", "score"])
def test_forward_at_the_coarse_size_matches_flax(net, tmp_path):
    """One forward at 112 px (the documented coarse size: a 14x14 token grid,
    so the 20x20 positional table is regridded on both sides) against flax,
    float32, atol 2e-4 + rtol 1e-3 as for the other sizes."""
    rng = np.random.default_rng(7)
    A = rng.uniform(-1, 1, (2, 112, 112, 6)).astype(np.float32)
    B = rng.uniform(-1, 1, (2, 112, 112, 6)).astype(np.float32)
    if net == "refine":
        jnet, tnet = JRefineNet(norm=None, dtype=jnp.float32), RefineNet(norm=None)
        jparams = jnet.init(jax.random.PRNGKey(1), A[:1], B[:1])
        ref = jnet.apply(jparams, A, B)
        _carry(jparams, tnet, tmp_path, net)
        with torch.no_grad():
            out = tnet.eval()(torch.tensor(A), torch.tensor(B))
        pairs = [(out[k].numpy(), np.asarray(ref[k])) for k in ("trans", "rot")]
    else:
        jnet = JScoreNet(norm="group", dtype=jnp.float32, residual_attn=True)
        tnet = ScoreNetMultiPair(norm="group", residual_attn=True)
        jparams = jnet.init(jax.random.PRNGKey(2), A, B, 2)
        ref = jnet.apply(jparams, A, B, 2)["score_logit"]
        _carry(jparams, tnet, tmp_path, net)
        with torch.no_grad():
            out = tnet.eval()(torch.tensor(A), torch.tensor(B), 2)["score_logit"]
        pairs = [(out.numpy(), np.asarray(ref))]
    for o, r in pairs:
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=1e-3)
