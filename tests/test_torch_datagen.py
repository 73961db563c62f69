"""Port parity for the training data: ``core/geometry`` additions, the mesh
corpus, ``models/datagen.py`` against foundationpose_tpu/models/datagen.py.

``jax.random`` cannot be reproduced in torch, so the random part of every
function is fed across: the test makes the JAX package's draws with the same
``jax.random`` calls its functions make and hands them to the port's
arithmetic (poses recovered from the JAX batch's ``poseA`` / ``poseB``).

Gates (float32 on both sides, CPU):
- geometry: 1e-6;
- corpus meshes and surface samples: bit for bit (pure numpy on both sides);
- batches (``augment=False``): the rasterizer's parity gates, as
  ``tests/test_torch_crop.py`` states them — all but < 1e-3 of the crop
  elements within 1e-4 (normalised xyz: 2e-4, the xyz scaled by 2 / diameter),
  because a silhouette or shared-edge pixel may flip between the two float32
  rasterizers; targets (``trans_gt``, ``rot_gt``, ``adds``) within 1e-5;
- ``augment_observed``: 1e-5 on every element (element-wise arithmetic on the
  same draws); ``composite_distractor``: the batch gate (it renders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models import corpus as jcorpus
from foundationpose_tpu.models import datagen as jdatagen
from foundationpose_tpu.ops import raster as jraster
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.models import agnostic, corpus, datagen
from foundationpose_tpu_torch.ops import raster

torch.set_num_threads(1)
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
S, B = 32, 4


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close_mostly(a, b, tol, frac=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    bad = np.abs(a - b) > tol
    assert bad.mean() < frac, f"{bad.mean():.2e} of elements beyond {tol}"


@pytest.fixture(scope="module")
def meshes():
    """The corpus's first vertex-coloured and first textured mesh, centred,
    with both packages' mesh tensors."""
    out = {}
    for i, m in enumerate(corpus.build_corpus(12, seed=7)):
        kind = "tex" if m.texture is not None else "vc"
        if kind in out:
            continue
        b = m.bounds
        c = m.translated(-(b[0] + b[1]) / 2)
        from foundationpose_tpu_torch.core import meshio

        out[kind] = dict(mesh=c, mt=raster.make_mesh_tensors(c, max_faces=512, device="cpu"),
                         jmt=jraster.make_mesh_tensors(c, max_faces=512),
                         diameter=float(meshio.compute_mesh_diameter(mesh=c)))
    assert set(out) == {"tex", "vc"}
    return out


def test_transform_pts_and_egocentric_delta_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.1, (7, 3)).astype(np.float32)
    tf = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    tf[:, :3, :3] = np.asarray(jgeo.so3_exp_map(rng.normal(0, 1, (5, 3)).astype(np.float32)))
    tf[:, :3, 3] = rng.normal(0, 0.3, (5, 3))
    for p, t in ((pts, tf), (pts, tf[0]), (np.tile(pts[None], (5, 1, 1)), tf)):
        np.testing.assert_allclose(geo.transform_pts(p, t).numpy(),
                                   np.asarray(jgeo.transform_pts(p, t)), atol=1e-6)
    A, Bp = tf[:3], tf[2:]
    td, rd = geo.pose_to_egocentric_delta_pose(_t(A), _t(Bp))
    jtd, jrd = jgeo.pose_to_egocentric_delta_pose(jnp.asarray(A), jnp.asarray(Bp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)
    # the port's inverse brings A back onto B
    np.testing.assert_allclose(geo.egocentric_delta_pose_to_pose(_t(A), td, rd).numpy(), Bp,
                               atol=1e-5)


def test_corpus_and_surface_points_bit_for_bit():
    for seed in (0, 7):
        for m, jm in zip(corpus.build_corpus(10, seed=seed), jcorpus.build_corpus(10, seed=seed)):
            for key in ("vertices", "faces", "vertex_normals", "uv", "texture", "vertex_colors"):
                a, b = getattr(m, key), getattr(jm, key)
                assert (a is None) == (b is None), key
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            for i in (0, 3):
                np.testing.assert_array_equal(agnostic._sample_surface_points(m, 64, seed=i),
                                              jagnostic._sample_surface_points(jm, 64, seed=i))
    kinds = {m.texture is not None for m in corpus.build_corpus(12, seed=7)}
    assert kinds == {True, False}  # both appearances in the corpus the tests use


@pytest.mark.parametrize("kind", ["vc", "tex"])
def test_refine_batch_matches_jax(meshes, kind):
    m = meshes[kind]
    jb = jdatagen.make_refine_batch(jax.random.PRNGKey(3), m["jmt"], jnp.asarray(K, jnp.float32),
                                    m["diameter"], batch=B, input_size=S, augment=False)
    out = datagen.refine_batch_from_poses(m["mt"], _t(K), m["diameter"], _t(jb["poseB"]),
                                          _t(jb["poseA"]), input_size=S)
    assert out["A"].shape == (B, S, S, 6)
    for key in ("A", "B"):
        ref = np.asarray(jb[key])
        assert np.abs(ref[..., :3]).sum() > 10  # the crops show the object
        _close_mostly(out[key][..., :3], ref[..., :3], 1e-4)
        _close_mostly(out[key][..., 3:], ref[..., 3:], 2e-4)
    for key in ("trans_gt", "rot_gt"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jb[key]), atol=1e-5)


@pytest.mark.parametrize("kind", ["vc", "tex"])
def test_score_batch_matches_jax(meshes, kind):
    m = meshes[kind]
    key = jax.random.PRNGKey(5)
    pts = np.asarray(m["mesh"].vertices, np.float32)
    jb = jdatagen.make_score_batch(key, m["jmt"], jnp.asarray(K, jnp.float32), m["diameter"],
                                   jnp.asarray(pts), n_hyp=B, input_size=S, augment=False)
    # replay the poses the JAX function drew from the same key
    kp, kd, _ = jax.random.split(key, 3)
    gt = jnp.repeat(jdatagen._sample_poses(kp, 1), B, axis=0)
    hyp = jdatagen._perturb(kd, gt, 0.04, 0.9)
    out = datagen.score_batch_from_poses(m["mt"], _t(K), m["diameter"], _t(pts), _t(gt),
                                         _t(hyp), input_size=S)
    for key_ in ("A", "B"):
        _close_mostly(out[key_][..., :3], np.asarray(jb[key_])[..., :3], 1e-4)
        _close_mostly(out[key_][..., 3:], np.asarray(jb[key_])[..., 3:], 2e-4)
    np.testing.assert_allclose(out["adds"].numpy(), np.asarray(jb["adds"]), atol=1e-5)


def _jax_augment_draws(key, Bn, Sn):
    """The draws ``_augment_observed`` makes from ``key``, by its own calls."""
    keys = jax.random.split(key, 12)
    occ_keys = jax.random.split(keys[9], 3)
    d = {
        "bg_col": jax.random.uniform(keys[0], (Bn, 1, 1, 3)),
        "noise": jax.random.normal(keys[1], (Bn, Sn, Sn, 3)),
        "cell": jax.random.randint(keys[10], (Bn, 1, 1), 4, 40),
        "col2": jax.random.uniform(keys[11], (Bn, 1, 1, 3)),
        "use_checker": jax.random.bernoulli(keys[10], 0.5, (Bn, 1, 1, 1)),
        "dz": jax.random.uniform(keys[2], (Bn, Sn, Sn, 1), minval=0.03, maxval=0.5),
        "dxy": jax.random.uniform(keys[3], (Bn, Sn, Sn, 2), minval=-2.0, maxval=2.0),
        "bg_on": jax.random.bernoulli(
            keys[4], jax.random.uniform(keys[5], (Bn, 1, 1, 1), minval=0.3, maxval=1.0),
            (Bn, Sn, Sn, 1)),
        "hole": jax.random.bernoulli(
            keys[7], jax.random.uniform(keys[6], (Bn, 1, 1), maxval=0.15),
            (Bn, Sn // 8, Sn // 8)),
        "occ_box": jax.random.uniform(keys[8], (Bn, 4)),
        "occ_on": jax.random.bernoulli(occ_keys[0], 0.5, (Bn, 1, 1)),
        "occ_col": jax.random.uniform(occ_keys[1], (Bn, 1, 1, 3)),
        "occ_dz": jax.random.uniform(occ_keys[2], (Bn, 1, 1, 1), minval=0.05, maxval=0.25),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_augment_observed_matches_jax_on_its_draws():
    rng = np.random.default_rng(1)
    Bn, Sn = 6, 32
    rgb = rng.uniform(0, 1, (Bn, Sn, Sn, 3)).astype(np.float32)
    xyz = rng.normal(0, 0.05, (Bn, Sn, Sn, 3)).astype(np.float32)
    xyz[..., 2] += 0.6
    mask = rng.uniform(size=(Bn, Sn, Sn)) < 0.4
    xyz[~mask] = 0.0
    t = rng.normal(0, 0.02, (Bn, 3)).astype(np.float32) + [0, 0, 0.6]
    t = t.astype(np.float32)
    key = jax.random.PRNGKey(11)
    jrgb, jxyz = jdatagen._augment_observed(key, rgb, xyz, mask, t, 0.06)
    d = _jax_augment_draws(key, Bn, Sn)
    assert d["use_checker"].any() and (~d["use_checker"]).any() and d["occ_on"].any()
    prgb, pxyz = datagen.augment_observed(_t(rgb), _t(xyz), torch.from_numpy(mask), _t(t), 0.06, d)
    np.testing.assert_allclose(prgb.numpy(), np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(pxyz.numpy(), np.asarray(jxyz), atol=1e-5)


@pytest.mark.parametrize("kind", ["vc", "tex"])
def test_composite_distractor_matches_jax_on_its_draws(meshes, kind):
    m = meshes[kind]
    jb = jdatagen.make_refine_batch(jax.random.PRNGKey(4), m["jmt"], jnp.asarray(K, jnp.float32),
                                    m["diameter"], batch=B, input_size=S, augment=False)
    gt, hyp = np.asarray(jb["poseB"]), np.asarray(jb["poseA"])
    tfs = np.asarray(jgeo.compute_crop_window_tf_batch(hyp, K, 1.2, m["diameter"], (S, S)))
    rB = jraster.render_crops(m["jmt"], gt, K, tfs, out_hw=(S, S), use_light=True)
    render_j = lambda mt, p, k, tf: jraster.render_crops(mt, p, k, tf, out_hw=(S, S),  # noqa: E731
                                                         use_light=True)
    for seed in range(9, 30):  # the first key whose distractor lands in a crop
        key = jax.random.PRNGKey(seed)
        jrgb, jxyz, jmask = jdatagen._composite_distractor(
            key, render_j, m["jmt"], jnp.asarray(K, jnp.float32), tfs, jnp.asarray(gt),
            m["diameter"], rB["rgb"], rB["xyz"], rB["mask"])
        if (np.asarray(jmask) != np.asarray(rB["mask"])).any():
            break
    else:
        raise AssertionError("no key drew a visible distractor")
    k1, k2, k3 = jax.random.split(key, 3)
    d = {"w": torch.from_numpy(np.array(jax.random.normal(k1, (B, 3)) * 2.0)),
         "direction": torch.from_numpy(np.array(jax.random.normal(k2, (B, 3)))),
         "dist": torch.from_numpy(np.array(jax.random.uniform(k3, (B, 1), minval=0.7, maxval=1.6))),
         "on": torch.from_numpy(np.array(jax.random.bernoulli(k2, 0.6, (B, 1, 1, 1))))}

    def render(p):
        return raster.render_crops(m["mt"], p, _t(K), _t(tfs), out_hw=(S, S), use_light=True,
                                   with_normal=False)

    prgb, pxyz, pmask = datagen.composite_distractor(
        render, _t(gt), m["diameter"], _t(rB["rgb"]), _t(rB["xyz"]),
        torch.from_numpy(np.array(rB["mask"])), d)
    _close_mostly(pmask.numpy(), np.asarray(jmask), 0.5)
    _close_mostly(prgb.numpy(), np.asarray(jrgb), 1e-4)
    _close_mostly(pxyz.numpy(), np.asarray(jxyz), 1e-4)


def test_augmented_batch_invariants(meshes):
    """The invariants of the JAX package's tests/test_agnostic.py on the
    port's own generator: augmentation leaves the targets and the rendered
    (A) side alone, keeps inputs in range, and changes B."""
    m = meshes["tex"]

    def batch(augment):
        gen = torch.Generator().manual_seed(0)
        return datagen.make_refine_batch(gen, m["mt"], _t(K), m["diameter"], batch=B,
                                         input_size=S, augment=augment)

    clean, aug = batch(False), batch(True)
    np.testing.assert_allclose(clean["trans_gt"].numpy(), aug["trans_gt"].numpy(), atol=1e-6)
    np.testing.assert_allclose(clean["A"].numpy(), aug["A"].numpy(), atol=1e-6)
    Bx = aug["B"].numpy()
    assert np.isfinite(Bx).all()
    assert (Bx[..., :3] >= 0).all() and (Bx[..., :3] <= 1).all()
    assert np.abs(Bx[..., 3:]).max() < 2.0 + 1e-5
    assert np.abs(Bx - clean["B"].numpy()).max() > 0.05
    # the same generator state gives the same batch; the draws stay on its device
    np.testing.assert_array_equal(batch(True)["B"].numpy(), Bx)
    assert np.abs(np.asarray(clean["trans_gt"])).max() <= 0.02 + 1e-6
    R = clean["rot_gt"].numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (B, 1, 1)), atol=1e-5)
