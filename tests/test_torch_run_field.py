"""Port parity for the field trainer (``field/runner.py``), its config I/O
(``utils/config.py``) and the reconstruction CLI (``apps/run_field.py``)
against the JAX package, on the CPU at the tiny configs of
tests/test_field.py.

Gates:
- ``_build_rays``: bit for bit against the JAX runner's rays (cv2 dilation
  with even and odd kernels);
- one train step with the JAX package's draws fed in (ray ids, the two
  stratified draws, the importance draw): loss and every aux term within
  1e-4 relative, every parameter's gradient within 1e-4 of its largest
  entry. The JAX gradients are read exactly: its step is rebuilt with an
  optax transformation that keeps the gradients as its state;
- the two-group Adam against ``optax.multi_transform`` over five steps of
  fed gradients: parameters within 1e-6 (the optimiser test's gate);
- a whole run is held by outcome (finite loss, artifacts, a mesh with
  faces): past its first step the field's training is chaotic.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_field import _sphere_scene

from foundationpose_tpu.field import bounds as jbounds
from foundationpose_tpu.field.runner import FieldConfig as JFieldConfig
from foundationpose_tpu.field.runner import NeRFRunnerTPU
from foundationpose_tpu.utils import config as jconfig
from foundationpose_tpu_torch.core import icosphere, meshio
from foundationpose_tpu_torch.field import runner as runner_mod
from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner
from foundationpose_tpu_torch.io import png
from foundationpose_tpu_torch.models import convert
from foundationpose_tpu_torch.ops import raster
from foundationpose_tpu_torch.utils import config as cfgmod

torch.set_num_threads(1)

TINY = dict(n_step=5, n_rand=64, n_samples=8, n_samples_around_depth=8,
            triplane_resolutions=(8, 16), triplane_channels=2, num_levels=3,
            log2_hashmap_size=10, base_res=4, finest_res=32,
            trunc=0.02, occ_resolution=16, mask_dilate_first=4, mask_dilate=4)


@pytest.fixture(scope="module")
def scene():
    K, cams, rgbs, depths, masks = _sphere_scene(n_views=4, H=30, W=40)
    translation, sc_factor, cluster = jbounds.compute_scene_bounds(depths, masks, K, cams,
                                                                   voxel=0.05)
    rgbs_n, depths_n, masks_n, poses_n = jbounds.preprocess_data(
        rgbs, depths, masks, cams, sc_factor, translation)
    occ = (cluster + translation) * sc_factor
    return (rgbs_n, depths_n, masks_n, poses_n, K, occ, sc_factor, translation)


def _runners(scene, **kw):
    cfg = dict(TINY, **kw)
    jr = NeRFRunnerTPU(JFieldConfig(**cfg), *scene)
    pr = NeRFRunner(FieldConfig(**cfg), *scene, device="cpu")
    pr.field.load_state_dict(convert.field_params_to_state_dict(jax.device_get(jr.params),
                                                                pr.field))
    return jr, pr


def test_field_config_matches_jax():
    assert dataclasses.asdict(FieldConfig()) == dataclasses.asdict(JFieldConfig())


@pytest.mark.parametrize("dil", [(4, 4), (5, 3), (50, 30), (0, 2)], ids=str)
def test_build_rays_bit_for_bit(scene, dil):
    jr, pr = _runners(scene, mask_dilate_first=dil[0], mask_dilate=dil[1])
    a, b = pr.rays.numpy(), np.asarray(jr.rays)
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_array_equal(a, b)


def test_dilate_mask_matches_cv2_even_and_odd():
    """cv2 anchors an even k x k kernel at k // 2: a set pixel at 4 dilates
    to 3..6 for k = 4; every k from 1 to 8 on a random mask."""
    import cv2

    m = np.zeros((1, 10), np.uint8)
    m[0, 4] = 1
    d = runner_mod.dilate_mask(torch.tensor(m), 4).numpy()
    np.testing.assert_array_equal(np.nonzero(d[0])[0], [3, 4, 5, 6])
    rng = np.random.default_rng(0)
    mask = (rng.random((23, 31)) > 0.97).astype(np.uint8)
    for k in range(1, 9):
        ref = cv2.dilate(mask, np.ones((k, k), np.uint8)) > 0
        np.testing.assert_array_equal(runner_mod.dilate_mask(torch.tensor(mask), k).numpy(), ref)


def _jax_draws(cfg, key):
    """The JAX step's draws from ``key`` (runner.py:282, sampling.py:85,130)."""
    key, k_imp = jax.random.split(key)
    k1, k2 = jax.random.split(key)
    n = cfg["n_rand"]
    d = {"u_uniform": jax.random.uniform(k1, (n, cfg["n_samples"])),
         "u_depth": jax.random.uniform(k2, (n, cfg["n_samples_around_depth"]))}
    if cfg.get("n_importance", 0):
        d["u_imp"] = jax.random.uniform(k_imp, (n, cfg["n_importance"]))
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _grad_keeping_tx():
    """An optax transformation whose update is zero and whose new state is
    the gradient: the step's returned state holds the exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("kw", [
    {},
    {"encoder": "hash"},
    {"eikonal_weight": 0.1, "fs_rgb_weight": 10.0},
    {"n_importance": 8},
], ids=["triplane", "hash", "eikonal_fs_rgb", "n_importance"])
def test_train_step_matches_jax(scene, kw):
    cfg = dict(TINY, **kw)
    jr, pr = _runners(scene, **kw)
    key = jax.random.PRNGKey(11)
    ids = np.random.default_rng(0).integers(0, jr.rays.shape[0], cfg["n_rand"])
    jr.tx = _grad_keeping_tx()
    jr.opt_state = jr.tx.init(jr.params)
    step = jr._make_train_step()
    _, jgrads, jloss, jaux = step(jr.params, jr.opt_state, key, jr.rays[ids])

    draws = _jax_draws(cfg, key)
    draws["ids"] = torch.tensor(ids)
    loss, aux = pr.grads(draws)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert int(aux["valid_samples"]) > 0
    ref = convert.field_params_to_state_dict(jax.device_get(jgrads), pr.field)
    for name, p in pr.field.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        scale = max(np.abs(r).max(), 1e-12)
        assert np.abs(g - r).max() <= 1e-4 * scale, (name, np.abs(g - r).max(), scale)
    if cfg.get("eikonal_weight"):
        assert np.abs(pr.field.grid.planes_8.grad.numpy()).max() > 0


def test_two_group_adam_matches_optax_multi_transform(scene):
    """The runner's two optimisers (pose array, everything else) against the
    JAX runner's ``optax.multi_transform`` on the same fed gradients, five
    steps of its decaying schedules."""
    jr, pr = _runners(scene, n_step=4, lrate=0.02, lrate_pose=0.005)
    params, state = jr.params, jr.opt_state
    rng = np.random.default_rng(1)
    names = dict(pr.field.named_parameters())
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.normal(0, 1, x.shape).astype(np.float32) * 1e-3, params)
        updates, state = jr.tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        tg = convert.field_params_to_state_dict(g, pr.field)
        for name, p in names.items():
            p.grad = tg[name]
        pr.opt.step()
        pr.opt_pose.step()
        ref = convert.field_params_to_state_dict(jax.device_get(params), pr.field)
        for name, p in names.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert int(pr.opt.count) == int(pr.opt_pose.count) == 5
    assert [p is pr.field.pose_array for p in pr.opt_pose.params] == [True]


def test_train_runs_and_logs_aux_on_the_host(scene):
    pr = NeRFRunner(FieldConfig(**TINY), *scene, device="cpu")
    loss = pr.train(log_every=2)
    assert np.isfinite(loss) and pr.global_step == TINY["n_step"]
    for key in ("loss", "rgb_loss", "fs_loss", "sdf_loss", "empty_loss", "valid_rays",
                "valid_samples"):
        assert isinstance(pr.last_aux[key], float) and np.isfinite(pr.last_aux[key])
    opt = pr.get_optimized_poses_in_real_world()
    assert opt.shape == (4, 4, 4) and np.isfinite(opt).all()


def test_save_load_round_trip(scene, tmp_path):
    a = NeRFRunner(FieldConfig(**TINY), *scene, device="cpu")
    a.train(n_step=3, log_every=10)
    path = str(tmp_path / "field.ckpt")
    a.save(path)
    b = NeRFRunner(FieldConfig(**dict(TINY, seed=5)), *scene, device="cpu")
    b.load(path)
    assert b.global_step == 3
    for (n, p), q in zip(a.field.state_dict().items(), b.field.state_dict().values()):
        assert torch.equal(p, q), n
    for x, y in zip([*a.opt.mu, *a.opt.nu, a.opt.count], [*b.opt.mu, *b.opt.nu, b.opt.count]):
        assert torch.equal(x, y)
    draws = a.draw()
    b.gen.set_state(a.gen.get_state())
    # the same next step from the loaded state
    la, _ = a.train_step(a.draw())
    lb, _ = b.train_step(b.draw())
    assert torch.equal(la, lb)
    assert draws["ids"].shape == (TINY["n_rand"],)


def test_train_observability_and_artifact_hooks(scene, tmp_path):
    """Mirror of tests/test_field.py::test_train_observability_and_artifact_hooks:
    the i_weights / i_img / i_mesh hooks leave ckpt/, image_step/*.png (the
    port's PNG writer) and mesh_step/*.obj under save_dir."""
    cfg = FieldConfig(**dict(TINY, n_step=6, mask_dilate_first=0, mask_dilate=0,
                             occ_resolution=8, mesh_resolution=0.15,
                             i_weights=3, i_img=3, i_mesh=6, save_dir=str(tmp_path)))
    pr = NeRFRunner(cfg, *scene, device="cpu")
    pr.train(n_step=6, log_every=2)
    assert os.path.exists(tmp_path / "ckpt" / "model_latest.npz")
    imgs = os.listdir(tmp_path / "image_step")
    assert any(f.endswith(".png") for f in imgs), imgs
    img = png.read_png(str(tmp_path / "image_step" / sorted(imgs)[0]))
    assert img.shape == (8, 10, 3) and img.dtype == np.uint8
    meshes = os.listdir(tmp_path / "mesh_step")
    assert any(f.endswith(".obj") for f in meshes), meshes


def test_runner_refuses_without_a_device(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeRFRunner(FieldConfig(**TINY), *scene)


# ---------------------------------------------------------------------------
# config I/O (mirror of tests/test_multi_config.py:72-100)


def test_yaml_config_roundtrip(tmp_path):
    cfg = FieldConfig(n_step=123, n_rand=99, triplane_resolutions=(8, 16))
    p = str(tmp_path / "cfg.yml")
    cfgmod.save_yaml(cfg, p)
    loaded = cfgmod.load_yaml(FieldConfig, p)
    assert loaded == cfg
    assert cfgmod.load_yaml(FieldConfig, p, overrides={"n_step": 7}).n_step == 7
    # the JAX package reads the same file into its own FieldConfig
    assert dataclasses.asdict(jconfig.load_yaml(JFieldConfig, p)) == dataclasses.asdict(cfg)


def test_reference_style_field_yaml(tmp_path):
    """BundleSDF config_ycbv.yml-style keys are translated, as in the JAX
    package."""
    p = str(tmp_path / "ref.yml")
    with open(p, "w") as f:
        f.write("n_step: 77\nN_rand: 512\nN_samples: 16\nfinest_res: 256\n"
                "trunc: 0.02\nmultires_views: 3\ndilate_mask_size: 12\nunknown_key_xyz: 1\n")
    cfg = cfgmod.load_field_config(p)
    assert (cfg.n_step, cfg.n_rand, cfg.n_samples, cfg.finest_res, cfg.trunc, cfg.sh_degree,
            cfg.mask_dilate) == (77, 512, 16, 256, 0.02, 3, 12)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig.load_field_config(p))
    assert cfgmod._FIELD_KEY_MAP == jconfig._FIELD_KEY_MAP


def test_missing_yaml_names_it(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        cfgmod.save_yaml(FieldConfig(), str(tmp_path / "x.yml"))


# ---------------------------------------------------------------------------
# the CLI on trees written with the port's PNG writer

HW = (60, 80)
KCAM = np.array([[110.0, 0, 40], [0, 110.0, 30], [0, 0, 1]])


def _l_mesh():
    """The demo's L-shape with position-coded vertex colours."""
    from foundationpose_tpu_torch.apps.demo_synthetic import make_l_shape

    m = make_l_shape()
    v = m.vertices
    m.vertex_colors = ((v - v.min(0)) / np.ptp(v, 0) * 200 + 40).astype(np.uint8)
    return m


def _views(n=12, dist=0.5):
    cams = np.asarray(icosphere.sample_views_icosphere(n_views=n), np.float64)[:n]
    cams[:, :3, 3] = cams[:, :3, 3] * dist + _l_mesh().bounds.mean(axis=0)
    return [np.linalg.inv(c) for c in cams]  # ob_in_cam


def _frames():
    mt = raster.make_mesh_tensors(_l_mesh(), device="cpu")
    out = []
    for pose in _views():
        r = raster.render_full_frame(mt, pose[None], KCAM, HW, use_light=False)
        m = r["mask"][0].numpy()
        out.append(((r["rgb"][0].numpy() * 255).astype(np.uint8),
                    np.rint(np.where(m, r["depth"][0].numpy(), 0) * 1000).astype(np.uint16),
                    m.astype(np.uint8) * 255, pose))
    return out


def _write_ycbineoat(root, frames):
    for sub in ("rgb", "depth", "masks", "annotated_poses"):
        os.makedirs(os.path.join(root, sub))
    np.savetxt(os.path.join(root, "cam_K.txt"), KCAM)
    for i, (rgb, depth, mask, pose) in enumerate(frames):
        png.write_png(os.path.join(root, "rgb", f"{i:04d}.png"), rgb)
        png.write_png(os.path.join(root, "depth", f"{i:04d}.png"), depth)
        png.write_png(os.path.join(root, "masks", f"{i:04d}.png"), mask)
        np.savetxt(os.path.join(root, "annotated_poses", f"{i:04d}.txt"), pose)


def _write_bop(root, frames):
    scene_dir = os.path.join(root, "test", "000048")
    for sub in ("rgb", "depth", "mask_visib", "mask"):
        os.makedirs(os.path.join(scene_dir, sub))
    models = os.path.join(root, "ycbv_models", "models")
    os.makedirs(models)
    mesh = _l_mesh()
    meshio.save_ply(os.path.join(models, "obj_000001.ply"),
                    meshio.Mesh(mesh.vertices * 1000, mesh.faces, vertex_colors=mesh.vertex_colors))
    info = {str(i): {"diameter": 120.0} for i in range(1, 22)}
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    cam, gt = {}, {}
    for i, (rgb, depth, mask, pose) in enumerate(frames):
        png.write_png(os.path.join(scene_dir, "rgb", f"{i:06d}.png"), rgb)
        png.write_png(os.path.join(scene_dir, "depth", f"{i:06d}.png"), depth)
        for sub in ("mask_visib", "mask"):
            png.write_png(os.path.join(scene_dir, sub, f"{i:06d}_000000.png"), mask)
        cam[str(i)] = {"cam_K": KCAM.reshape(-1).tolist(), "depth_scale": 1.0}
        gt[str(i)] = [{"obj_id": 1, "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                       "cam_t_m2c": (pose[:3, 3] * 1000).tolist()}]
    for name, obj in (("scene_camera.json", cam), ("scene_gt.json", gt)):
        with open(os.path.join(scene_dir, name), "w") as f:
            json.dump(obj, f)
    return scene_dir


@pytest.mark.parametrize("tree", ["ycbineoat", "bop"])
def test_run_field_main_on_a_tree(tmp_path, tree):
    """``run_field.main(..., "--device", "cpu")`` leaves a textured mesh with
    faces, ``optimized_poses.txt`` (frame 0 at its input pose) and a
    checkpoint; a reference-style YAML shrinks the config."""
    from foundationpose_tpu_torch.apps import run_field

    frames = _frames()
    root = str(tmp_path / ("bleach0" if tree == "ycbineoat" else "ycbv"))
    src = (["--data-dir", root] if tree == "ycbineoat"
           else ["--video-dir", _write_bop(root, frames), "--ob-id", "1"])
    if tree == "ycbineoat":
        _write_ycbineoat(root, frames)
    cfg = str(tmp_path / "cfg.yml")
    with open(cfg, "w") as f:
        f.write("N_rand: 512\nN_samples: 24\nN_samples_around_depth: 24\nmesh_resolution: 0.006\n"
                "dilate_mask_size: 4\n")
    out = str(tmp_path / "out")
    mesh, poses, runner = run_field.main(src + ["--cfg", cfg, "--n-step", "60", "--n-frames", "12",
                                        "--save-dir", out, "--tex-res", "64",
                                        "--device", "cpu"])
    assert len(mesh.faces) > 0 and mesh.texture is not None and mesh.texture.shape == (64, 64, 3)
    loaded = meshio.load_obj(os.path.join(out, "mesh_real_world.obj"))
    assert len(loaded.faces) == len(mesh.faces)
    opt = np.loadtxt(os.path.join(out, "optimized_poses.txt")).reshape(-1, 4, 4)
    assert opt.shape == (12, 4, 4)
    np.testing.assert_allclose(opt[0], np.linalg.inv(frames[0][3]), atol=1e-4)
    ck = torch.load(os.path.join(out, "field_latest.ckpt"), weights_only=True)
    assert ck["global_step"] == 60 and ck["cfg"]["n_rand"] == 512
    assert [step for step, _ in runner.log] == [0] and np.isfinite(runner.log[0][1]["loss"])
    # the mesh lies near the true surface: within 1 cm of the true box extent
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    true = _l_mesh().vertices
    assert np.abs(lo - true.min(0)).max() < 0.02 and np.abs(hi - true.max(0)).max() < 0.02
