"""Port parity for the accuracy suite (``evalsuite/scenes.py``,
``evalsuite/harness.py``).

- ``build_suite`` gives the same meshes, symmetries, distractors and
  specs as the JAX package (symmetry and distractor poses from float32 Euler
  matrices: within 1e-6; everything else equal).
- ``SceneRenderer.render`` at quarter resolution (120x160) agrees with the
  JAX renderer as tests/test_torch_raster.py holds renders: visible masks on
  > 0.999 of pixels; on >= 0.98 of the pixels both call visible depth within
  1e-5 m and rgb within 1e-4 * 255, on all of them depth within 2e-3 m (a
  winner may flip where two faces tie in float32, at a rim or a shared edge).
- ``track_trajectory`` chains 60 float32 ``so3_exp_map`` products: within
  1e-6 of the JAX trajectory.
- The harness writes the JSON contract of ``ACCURACY_r05.json`` key for key.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from foundationpose_tpu.evalsuite import harness as jharness, scenes as jscenes
from foundationpose_tpu_torch.evalsuite import harness, scenes

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QK = scenes.K_DEFAULT.copy()
QK[:2] *= 0.25
QHW = (120, 160)


def _same_mesh(a, b):
    for k in ("vertices", "faces", "vertex_normals", "uv", "texture", "vertex_colors"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.shape == y.shape and x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("quick", [False, True])
def test_build_suite_matches_jax(quick):
    port, ref = scenes.build_suite(quick), jscenes.build_suite(quick)
    assert [s.name for s in port] == [s.name for s in ref]
    for a, b in zip(port, ref):
        _same_mesh(a.mesh, b.mesh)
        for f in ("backdrop", "z0", "n_register", "n_track", "learned", "pool_add", "seed"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        assert (a.symmetry_tfs is None) == (b.symmetry_tfs is None)
        if a.symmetry_tfs is not None:
            np.testing.assert_allclose(a.symmetry_tfs, b.symmetry_tfs, rtol=0, atol=1e-6)
        assert len(a.distractors) == len(b.distractors)
        for (ma, pa), (mb, pb) in zip(a.distractors, b.distractors):
            _same_mesh(ma, mb)
            np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sphere_occluded", "compound_clutter", "cylinder_tex"])
def test_scene_render_matches_jax(name):
    spec = [s for s in scenes.build_suite() if s.name == name][0]
    jspec = [s for s in jscenes.build_suite() if s.name == name][0]
    r = scenes.SceneRenderer(spec, K=QK, hw=QHW, device="cpu")
    jr = jscenes.SceneRenderer(jspec, K=QK, hw=QHW)
    gts, jgts = r.register_poses(), jr.register_poses()
    np.testing.assert_allclose(gts, jgts, rtol=0, atol=1e-6)
    for gt in gts[:2]:
        rgb, depth, vis, frac = r.render(gt)
        jrgb, jdepth, jvis, jfrac = jr.render(gt)
        assert rgb.shape == (120, 160, 3) and depth.shape == QHW and vis.dtype == np.uint8
        assert (vis == jvis).mean() > 0.999 and vis.any()
        both = (vis > 0) & (jvis > 0)
        close = (np.abs(depth - jdepth) < 1e-5) & (np.abs(rgb - jrgb).max(-1) < 1e-4 * 255)
        assert close[both].mean() >= 0.98
        # the rest are winner flips where two faces' depths tie in float32 (a
        # sphere's rim, where its front and back surfaces meet): still close
        assert np.abs(depth - jdepth)[both].max() < 2e-3
        # the static part (distractors, backdrop) where neither shows the object
        neither = (vis == 0) & (jvis == 0)
        assert (np.abs(depth - jdepth) < 1e-5)[neither].mean() >= 0.98
        assert np.abs(depth - jdepth)[neither].max() < 2e-3
        assert abs(frac - jfrac) < 1e-2


@pytest.mark.parametrize("name", ["box_gray", "compound_clutter"])
def test_track_trajectory_matches_jax(name):
    spec = [s for s in scenes.build_suite() if s.name == name][0]
    jspec = [s for s in jscenes.build_suite() if s.name == name][0]
    # the trajectory needs no render: build the renderers without their static pass
    r = scenes.SceneRenderer.__new__(scenes.SceneRenderer)
    jr = jscenes.SceneRenderer.__new__(jscenes.SceneRenderer)
    r.spec, jr.spec = spec, jspec
    traj, jtraj = r.track_trajectory(), jr.track_trajectory()
    assert traj.shape == jtraj.shape == (60, 4, 4)
    assert np.abs(traj - jtraj).max() <= 1e-6


def test_schedules_and_auc_match_jax():
    for px in (32, 48, 160):
        assert harness._schedules(px) == jharness._schedules(px)
    errs = np.random.default_rng(0).uniform(0, 0.1, 33)
    assert harness._auc(errs) == jharness._auc(errs)


def _key_tree(d):
    return {k: _key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_harness_json_contract(tmp_path, monkeypatch):
    """A tiny geometric run (one quarter-resolution scene, one register trial,
    three tracked frames, a 4-view grid, 32 px) writes the JSON of the JAX
    harness, key for key as ``ACCURACY_r05.json`` has it."""
    spec = [s for s in scenes.build_suite(quick=True) if s.name == "compound_clutter"][0]
    monkeypatch.setattr(scenes, "build_suite",
                        lambda quick=False: [dataclasses.replace(spec, n_register=1, n_track=3)])
    out = tmp_path / "acc.json"
    res = harness.run_accuracy(out_path=str(out), quick=True, modes=("geometric",),
                               input_size=32, hyp_grid=dict(min_n_views=4, inplane_step=180),
                               device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    with open(os.path.join(ROOT, "ACCURACY_r05.json")) as f:
        ref = json.load(f)
    assert set(res) == set(ref) and set(res["meta"]) == set(ref["meta"])
    assert res["meta"]["device"] == "cpu" and res["meta"]["scenes"] == ["compound_clutter"]
    block, rblock = res["modes"]["geometric"], ref["modes"]["geometric"]
    assert set(block) == set(rblock) and set(block["register"]) == set(rblock["register"])
    assert block["register"]["coarse112"] == rblock["register"]["coarse112"]
    for sched in ("full", "funnel"):
        got, want = block["register"][sched], rblock["register"][sched]
        assert set(got) == set(want)
        assert _key_tree(got["scenes"]["compound_clutter"]) == \
            _key_tree(want["scenes"]["compound_clutter"])
        assert len(got["scenes"]["compound_clutter"]["adds"]) == 1
    assert _key_tree(block["track"]["scenes"]["compound_clutter"]) == \
        _key_tree(rblock["track"]["scenes"]["compound_clutter"])
    assert block["track"]["scenes"]["compound_clutter"]["n_frames"] == 3
    assert set(block["track"]) == set(rblock["track"])
    assert set(res["summary"]) <= set(ref["summary"])


def test_harness_refuses_what_waits_for_the_training_slice():
    """Nothing waits any more: without an agnostic checkpoint ``learned``
    trains per scene (tests/test_torch_agnostic.py). What the harness still
    refuses is a checkpoint directory that is not there, and the card when
    there is none."""
    with pytest.raises(FileNotFoundError, match="agnostic checkpoint"):
        harness.run_accuracy(modes=("learned",), agnostic_dir="/no/such/dir", device="cpu",
                             scene_names=["no_such_scene"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            harness.run_accuracy(modes=("geometric",))


@pytest.mark.slow
def test_quick_harness_matches_jax():
    """The quick configuration of both harnesses, geometric mode, 48 px:
    per-trial ADD-S within 1 % of the scene's mesh diameter (the ICP
    standard of the port), the same pooled AUC within 0.05."""
    from foundationpose_tpu_torch.core import meshio

    res = harness.run_accuracy(quick=True, modes=("geometric",), input_size=48, device="cpu")
    ref = jharness.run_accuracy(quick=True, modes=("geometric",), input_size=48)
    diam = {s.name: meshio.compute_mesh_diameter(mesh=s.mesh)
            for s in scenes.build_suite(quick=True)}
    for sched in ("full", "funnel"):
        got = res["modes"]["geometric"]["register"][sched]
        want = ref["modes"]["geometric"]["register"][sched]
        for name, sc in got["scenes"].items():
            d = np.abs(np.asarray(sc["adds"]) - want["scenes"][name]["adds"])
            assert (d <= 0.01 * diam[name]).all(), (sched, name, d)
        assert abs(got["overall_auc_adds"] - want["overall_auc_adds"]) <= 0.05


def test_unknown_scene_names_raise_unlike_jax():
    """A misspelt ``scene_names`` entry: the port raises a ``ValueError``
    naming it; the JAX package (left as it is) filters the suite to nothing
    and pools NaN AUCs. The divergence is on this error path only."""
    with pytest.raises(ValueError, match="box_grey"):
        harness.run_accuracy(quick=True, modes=("geometric",), scene_names=["box_grey"],
                             device="cpu")
    ref = jharness.run_accuracy(quick=True, modes=("geometric",), scene_names=["box_grey"])
    assert ref["meta"]["n_scenes"] == 0
    assert np.isnan(ref["modes"]["geometric"]["register"]["full"]["overall_auc_adds"])
