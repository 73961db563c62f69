"""Port parity for the entry points of the evaluation and I/O slice:
``apps/eval_bop.py``, ``apps/run_track.py``, ``apps/run_pose.py``,
``detect/pipeline.py``, ``utils/vis.py`` and the estimator's debug dumps.

- The three parsers have the JAX parsers' options and defaults, apart from
  the port's ``--device``.
- ``eval_bop.evaluate_scene`` in geometric mode on the rendered BOP tree of
  tests/test_eval_drivers.py, at that file's tiny configuration: frame by
  frame the same best rotation-grid hypothesis as the JAX package, and ADD
  within 1 % of the diameter (the ICP standard, ``ROADMAP.md`` queue 3).
- ``run_track.track_video``: streamed poses equal synchronous ones within
  1e-6; ``run_pose.main`` writes the pose and every debug PNG.
- ``depth_box_fallback`` and the ``AutoMasker`` refusals as tests/test_detect.py
  has them; component ties resolved as cv2 resolves them.
- The numpy drawing: depth colouring within one grey level of cv2's jet,
  grids equal, lines on the pixels cv2 draws up to anti-aliasing.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from test_eval_drivers import _write_rendered_scene  # noqa: E402

from foundationpose_tpu.apps import eval_bop as jeval_bop  # noqa: E402
from foundationpose_tpu.apps import run_pose as jrun_pose, run_track as jrun_track  # noqa: E402
from foundationpose_tpu.detect import pipeline as jpipeline  # noqa: E402
from foundationpose_tpu.engine.estimator import FoundationPoseTPU  # noqa: E402
from foundationpose_tpu.utils import vis as jvis  # noqa: E402
from foundationpose_tpu_torch.apps import eval_bop, run_pose, run_track  # noqa: E402
from foundationpose_tpu_torch.core import geometry as geo, meshio  # noqa: E402
from foundationpose_tpu_torch.detect import pipeline  # noqa: E402
from foundationpose_tpu_torch.engine import estimator as est_mod, geometric  # noqa: E402
from foundationpose_tpu_torch.io import png  # noqa: E402
from foundationpose_tpu_torch.ops import raster  # noqa: E402
from foundationpose_tpu_torch.utils import vis  # noqa: E402

torch.set_num_threads(1)


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.type,
                     tuple(a.choices) if a.choices else None, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,ref", [(run_pose, jrun_pose), (run_track, jrun_track),
                                      (eval_bop, jeval_bop)])
def test_parsers_match_jax(port, ref):
    got, want = _options(port.build_parser()), _options(ref.build_parser())
    assert got.pop("device") == (("--device",), None, False, None, None, "_StoreAction")
    if port is run_pose:  # the port's own SAM on a detector's box
        assert got.pop("box") == (("--box",), None, False, None, None, "_StoreAction")
    assert got == want


def test_run_pose_defaults():
    args = run_pose.build_parser().parse_args(
        ["--rgb", "a", "--depth", "b", "--intrinsics", "c", "--mesh", "d"])
    assert args.mode == "geometric" and args.debug == 1 and args.mask is None
    assert args.to_inches and args.nt_server is None and args.weights is None


# ---------------------------------------------------------------------------
# eval_bop against the JAX package


def _capture_best(monkeypatch, cls, log):
    reg = cls.register

    def register(self, *a, **kw):
        pose = reg(self, *a, **kw)
        log.append(int(self.hyp_order[0]))
        return pose

    monkeypatch.setattr(cls, "register", register)


def test_evaluate_scene_matches_jax(tmp_path, monkeypatch):
    from foundationpose_tpu.engine.estimator import EstimatorConfig as JCfg
    from foundationpose_tpu.engine.geometric import GeometricConfig as JGCfg
    from foundationpose_tpu.io.datareader import get_bop_reader as jget
    from foundationpose_tpu_torch.io.datareader import get_bop_reader

    scene = _write_rendered_scene(str(tmp_path / "bop" / "ycbv"), n_frames=2)
    kw = dict(min_n_views=4, inplane_step=180, register_iterations=2, track_iterations=1)
    best, jbest = [], []
    _capture_best(monkeypatch, est_mod.FoundationPoseTorch, best)
    _capture_best(monkeypatch, FoundationPoseTPU, jbest)
    got = eval_bop.evaluate_scene(
        get_bop_reader(scene), 1, mode="geometric", track=False,
        estimator_config=est_mod.EstimatorConfig(**kw),
        geometric_config=geometric.GeometricConfig(input_size=32), device="cpu")
    want = jeval_bop.evaluate_scene(
        jget(scene), 1, mode="geometric", track=False, estimator_config=JCfg(**kw),
        geometric_config=JGCfg(input_size=32))
    assert got["n_frames"] == want["n_frames"] == 2 and best == jbest
    diameter = get_bop_reader(scene).get_model_diameter(1)
    for a, b in zip(got["frames"], want["frames"]):
        assert a["frame"] == b["frame"]
        assert abs(a["add"] - b["add"]) <= 0.01 * diameter
        assert abs(a["adds"] - b["adds"]) <= 0.01 * diameter
    assert set(got) == set(want)
    # the video protocol: register frame 0, track frame 1
    tracked = eval_bop.evaluate_scene(
        get_bop_reader(scene), 1, mode="geometric", track=True,
        estimator_config=est_mod.EstimatorConfig(**kw),
        geometric_config=geometric.GeometricConfig(input_size=32), device="cpu")
    assert tracked["n_frames"] == 2 and all(np.isfinite(r["adds"]) for r in tracked["frames"])


# ---------------------------------------------------------------------------
# run_track and run_pose on trees the port writes itself

K = np.array([[250.0, 0, 80], [0, 250.0, 60], [0, 0, 1]])
HW = (120, 160)


def _l_mesh():
    a = meshio.make_box((0.12, 0.04, 0.04))
    b = meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0])
    c = meshio.make_box((0.04, 0.04, 0.07)).translated([-0.04, 0.0, 0.055])
    parts = [a, b, c]
    verts = np.concatenate([m.vertices for m in parts])
    offs = np.cumsum([0] + [len(m.vertices) for m in parts[:-1]])
    m = meshio.Mesh(verts, np.concatenate([p.faces + o for p, o in zip(parts, offs)]))
    m.vertex_colors = np.full((len(verts), 3), 180, np.uint8)
    return m


def _pose(i):
    p = np.eye(4)
    p[:3, :3] = geo.euler_matrix(0.3, -0.2, 0.5)[:3, :3].numpy()
    p[:3, 3] = np.array([0.01, -0.02, 0.55]) + np.array([0.004, -0.002, 0.005]) * i
    return p


def _render(mt, pose):
    out = raster.render_full_frame(mt, pose[None], K, HW)
    m = out["mask"][0].numpy()
    rgb = (out["rgb"][0].numpy() * 255).astype(np.uint8)
    depth = np.where(m, out["depth"][0].numpy(), 0.8)
    return rgb, depth, m


def _write_video(root, mesh, n):
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    for sub in ("rgb", "depth", "masks", "annotated_poses"):
        os.makedirs(os.path.join(root, sub))
    np.savetxt(os.path.join(root, "cam_K.txt"), K)
    for i in range(n):
        rgb, depth, m = _render(mt, _pose(i))
        png.write_png(os.path.join(root, "rgb", f"{i:04d}.png"), rgb)
        png.write_png(os.path.join(root, "depth", f"{i:04d}.png"),
                      np.rint(depth * 1000).astype(np.uint16))
        png.write_png(os.path.join(root, "masks", f"{i:04d}.png"), m.astype(np.uint8) * 255)
        np.savetxt(os.path.join(root, "annotated_poses", f"{i:04d}.txt"), _pose(i))


@pytest.fixture
def small_engine(monkeypatch):
    """The CLIs build their engines with the default configuration; shrink
    it (4-view grid, 32 px ICP) so that they run in seconds on the CPU."""
    monkeypatch.setattr(est_mod, "EstimatorConfig",
                        functools.partial(est_mod.EstimatorConfig, min_n_views=4,
                                          inplane_step=180))
    monkeypatch.setattr(geometric, "GeometricConfig",
                        functools.partial(geometric.GeometricConfig, input_size=32))


def test_track_video_stream_equals_sync(tmp_path, small_engine, monkeypatch):
    from foundationpose_tpu_torch.io.datareader import YcbineoatReader

    mesh = _l_mesh()
    _write_video(str(tmp_path / "video"), mesh, 3)
    reader = YcbineoatReader(str(tmp_path / "video"))
    kw = dict(mesh=mesh, est_refine_iter=1, track_refine_iter=1, device="cpu")
    res_s, summ_s = run_track.track_video(reader, stream=True, **kw)
    res_n, summ_n = run_track.track_video(reader, stream=False, **kw)
    assert [r["i"] for r in res_s] == [r["i"] for r in res_n] == [0, 1, 2]
    for a, b in zip(res_s, res_n):
        assert np.abs(np.asarray(a["pose"]) - b["pose"]).max() <= 1e-6
        assert abs(a["adds"] - b["adds"]) <= 1e-6
    assert set(summ_s) == {"frames", "track_fps", "adds_mean", "adds_recall_0.1d",
                           "adds_auc_0.1", "ate_rmse"}
    assert summ_s["frames"] == 3 and summ_s["ate_rmse"] is not None
    # --weights (learned mode): an engine checkpoint file of the port; an
    # orbax directory of the JAX package is refused with the npz bridge named
    from foundationpose_tpu_torch.models import checkpoint

    src = est_mod.FoundationPoseTorch(mesh, device="cpu")
    with torch.no_grad():
        src.refiner.net.trans_out.bias.add_(0.01)
    path = str(tmp_path / "engine.pt")
    checkpoint.save_engine(src, path)
    loaded = []
    real_load = checkpoint.load_engine
    monkeypatch.setattr(checkpoint, "load_engine",
                        lambda est, p: (real_load(est, p), loaded.append(est))[0])
    res_w, _ = run_track.track_video(reader, mode="learned", weights=path, max_frames=2, **kw)
    assert len(res_w) == 2 and np.isfinite([r["adds"] for r in res_w]).all()
    assert torch.equal(loaded[0].refiner.net.trans_out.bias, src.refiner.net.trans_out.bias)
    with pytest.raises(ValueError, match="npz"):
        run_track.track_video(reader, mode="learned", weights=str(tmp_path), **kw)


def _write_pose_inputs(d, mesh):
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    rgb, depth, m = _render(mt, _pose(0))
    png.write_png(os.path.join(d, "rgb.png"), rgb)
    png.write_png(os.path.join(d, "depth.png"), np.rint(depth * 1000).astype(np.uint16))
    png.write_png(os.path.join(d, "mask.png"), m.astype(np.uint8) * 255)
    with open(os.path.join(d, "cam.conf"), "w") as f:  # ZED conf format
        f.write(f"[LEFT_CAM_FHD1200]\nfx={K[0, 0]}\nfy={K[1, 1]}\ncx={K[0, 2]}\ncy={K[1, 2]}\n")
    meshio.save_ply(os.path.join(d, "mesh.ply"), mesh)


def test_run_pose_main_writes_pose_and_debug_pngs(tmp_path, small_engine):
    mesh = _l_mesh()
    _write_pose_inputs(str(tmp_path), mesh)
    base = ["--rgb", str(tmp_path / "rgb.png"), "--depth", str(tmp_path / "depth.png"),
            "--intrinsics", str(tmp_path / "cam.conf"), "--mesh", str(tmp_path / "mesh.ply"),
            "--device", "cpu"]
    with pytest.raises(SystemExit):  # no way to get a mask
        run_pose.main(base + ["--out-dir", str(tmp_path / "none")])
    out = tmp_path / "out"
    pose = run_pose.main(base + ["--mask", str(tmp_path / "mask.png"), "--out-dir", str(out),
                                 "--debug", "3", "--est-refine-iter", "1"])
    assert np.allclose(np.loadtxt(out / "pose.txt"), pose) and np.isfinite(pose).all()
    assert png.read_png(out / "vis.png").shape == HW + (3,)
    assert png.read_png(out / "vis_register.png").shape == HW + (3,)
    # 5 hypotheses x 160 px rows, [render | observed] with a 2-px gap
    assert png.read_png(out / "vis_score_top.png").shape == (5 * 160 + 4 * 5, 322, 3)
    iters = sorted(p.name for p in out.glob("vis_refine_iter_*.png"))
    # one per register iteration: twice --est-refine-iter in geometric mode
    assert iters == [f"vis_refine_iter_{i:02d}.png" for i in range(2)]


def test_debug_write_failure_never_breaks_register(tmp_path, monkeypatch, caplog):
    mesh = _l_mesh()
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    rgb, depth, m = _render(mt, _pose(0))
    g = geometric.GeometricConfig(input_size=32)
    est = est_mod.FoundationPoseTorch(
        mesh, config=est_mod.EstimatorConfig(min_n_views=4, inplane_step=180, debug=1,
                                             debug_dir=str(tmp_path / "dbg")),
        refiner=geometric.GeometricRefiner(g, "cpu"), scorer=geometric.GeometricScorer(g, "cpu"),
        device="cpu")

    def broken(path, img):
        raise OSError("disk full")

    monkeypatch.setattr(png, "write_png", broken)
    pose = est.register(K, rgb, depth, m)
    assert pose.shape == (4, 4) and "debug imwrite failed" in caplog.text


# ---------------------------------------------------------------------------
# detect and vis


def test_automasker_refusals_match_jax(tmp_path):
    for cls in (pipeline.AutoMasker, jpipeline.AutoMasker):
        with pytest.raises(FileNotFoundError, match="Grounding-DINO"):
            cls(detector_path="/nonexistent/dino", segmenter_path=str(tmp_path))
        with pytest.raises(FileNotFoundError, match="SAM"):
            cls(detector_path=str(tmp_path), segmenter_path="/nonexistent/sam")


def test_depth_box_fallback_matches_jax():
    rng = np.random.default_rng(0)
    depth = np.zeros((60, 80), np.float32)
    depth[5:15, 5:15] = 0.5
    depth[20:55, 30:70] = 0.8
    depth[0:60, 75:80] = 3.0
    cases = [depth, rng.uniform(0, 2, (48, 64)).astype(np.float32)]
    ties = np.zeros((40, 40), np.float32)  # two 10x10 blobs: equal areas
    ties[25:35, 2:12] = 0.6
    ties[3:13, 20:30] = 0.6
    cases.append(ties)
    for d in cases:
        for min_area in (1, 50, 500):
            a = pipeline.depth_box_fallback(d, min_area=min_area)
            b = jpipeline.depth_box_fallback(d, min_area=min_area)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pipeline.depth_box_fallback(ties, min_area=1)[4, 25] == 1  # the first in raster order


def test_vis_matches_cv2_drawing():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.3, 1.2, (40, 50))
    depth[:5] = 0
    for inverse in (True, False):
        assert np.array_equal(vis.depth_to_vis(depth, mode="gray", inverse=inverse),
                              jvis.depth_to_vis(depth, mode="gray", inverse=inverse))
        a = vis.depth_to_vis(depth, inverse=inverse).astype(int)
        assert np.abs(a - jvis.depth_to_vis(depth, inverse=inverse)).max() <= 1
    imgs = rng.integers(0, 256, (5, 12, 9, 3)).astype(np.uint8)
    assert np.array_equal(vis.make_grid_image(imgs, 2), jvis.make_grid_image(imgs, 2))
    # lines: the pixels cv2 draws (anti-aliased) against the port's (hard
    # edges): the cores agree
    img = np.zeros((120, 160, 3), np.uint8)
    pose = _pose(0)
    bounds = _l_mesh().bounds
    for draw in (lambda m, i: m.draw_posed_3d_box(K, i, pose, bounds),
                 lambda m, i: m.draw_xyz_axis(i, pose, scale=0.05, K=K)):
        a, b = draw(vis, img).any(-1), draw(jvis, img) > 128
        b = b.any(-1)
        assert a.sum() > 100 and (a & b).sum() / a.sum() > 0.95 and (a & b).sum() / b.sum() > 0.75


def test_readers_harness_and_clis_write_json_only_when_asked(tmp_path, small_engine):
    """``eval_bop --out`` writes the per-frame JSON; without ``--out`` nothing
    is written."""
    scene = _write_rendered_scene(str(tmp_path / "bop" / "ycbv"), n_frames=1)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        eval_bop.main(["--video-dir", scene, "--device", "cpu", "--max-frames", "1"])
        assert sorted(os.listdir(tmp_path)) == ["bop"]
        eval_bop.main(["--video-dir", scene, "--device", "cpu", "--max-frames", "1",
                       "--out", "r.json"])
    finally:
        os.chdir(cwd)
    with open(tmp_path / "r.json") as f:
        assert json.load(f)["n_frames"] == 1


def test_demo_synthetic_out_dir_writes_the_jax_demos_artefacts(tmp_path, monkeypatch):
    """``demo_synthetic --cpu --out-dir`` (a 120x160 scene, 1 tracked frame,
    geometric mode on a 4-view grid) writes the seven files of the JAX
    package's demo: the PNGs decode to the rendered frame and mask bit for
    bit, ``depth.npy`` / ``cam_K.txt`` are what ``register`` was given,
    ``gt_pose.txt`` the scene's true pose, ``object.obj`` the file the JAX
    package's ``save_obj`` writes for the same mesh, byte for byte."""
    from foundationpose_tpu.core import meshio as jmeshio
    from foundationpose_tpu_torch.apps import demo_synthetic as demo

    seen = {}
    make_scene, build = demo.make_scene, demo.build_estimator

    def scene_spy(*a, **k):
        seen["scene"] = make_scene(*a, **k)
        return seen["scene"]

    def small_estimator(mesh, device=None, mode="learned", **kw):
        est = build(mesh, device=device, mode=mode, input_size=32,
                    config=est_mod.EstimatorConfig(min_n_views=4, inplane_step=180,
                                                   register_iterations=2,
                                                   final_refine_iterations=1))
        register = est.register

        def register_spy(*a, **k):
            seen["register"] = a
            return register(*a, **k)

        est.register = register_spy
        return est

    monkeypatch.setattr(demo, "make_scene", scene_spy)
    monkeypatch.setattr(demo, "build_estimator", small_estimator)
    out = tmp_path / "demo"
    err = demo.main(["--cpu", "--out-dir", str(out), "--frames", "1", "--height", "120",
                     "--width", "160", "--mode", "geometric"])
    assert np.isfinite(err)
    assert sorted(os.listdir(out)) == sorted(demo.ARTEFACTS)
    sc, (K_reg, rgb_reg, depth_reg, mask_reg) = seen["scene"], seen["register"]
    np.testing.assert_array_equal(png.read_png(str(out / "rgb.png")), sc["rgb"])
    np.testing.assert_array_equal(png.read_png(str(out / "rgb.png")), rgb_reg)
    np.testing.assert_array_equal(png.read_png(str(out / "mask.png")),
                                  mask_reg.astype(np.uint8) * 255)
    depth = np.load(out / "depth.npy")
    assert depth.dtype == np.float32 and depth.shape == (120, 160)
    np.testing.assert_array_equal(depth, depth_reg)
    np.testing.assert_array_equal(np.loadtxt(out / "cam_K.txt"), K_reg)
    np.testing.assert_array_equal(np.loadtxt(out / "gt_pose.txt"), sc["gt"])
    m = sc["mesh"]
    jmeshio.save_obj(str(tmp_path / "jax.obj"),
                     jmeshio.Mesh(m.vertices, m.faces, vertex_colors=m.vertex_colors))
    assert (out / "object.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    vis_img = png.read_png(str(out / "vis_register.png"))
    assert vis_img.shape == sc["rgb"].shape and (vis_img != sc["rgb"]).any()


def test_demo_synthetic_cpu_flag_is_device_cpu():
    from foundationpose_tpu_torch.apps import demo_synthetic as demo

    with pytest.raises(SystemExit):
        demo.main(["--cpu", "--device", "cuda"])
