"""Port parity for the I/O slice: the PNG codec, the dataset readers, the
robot-camera loader, masks, pose conversion, mesh writers and the metrics
the evaluation drivers report.

- ``io/png.py`` round-trips every format it writes and decodes what cv2 and
  PIL write bit for bit (every filter cv2's and PIL's encoders choose).
- ``cv2.resize`` nearest is reproduced bit for bit; bilinear on uint8 within
  one grey level (cv2 rounds in 11-bit fixed point).
- The readers give equal outputs to the JAX package's on a synthetic BOP tree
  and a YCBInEOAT tree written with cv2: colour, depth and xyz exactly
  (float64 depth; xyz float32 on both sides), masks, K, poses, symmetries.
- ``compute_auc``, ``ate_rmse``, ``rpe`` and the SE3 alignment are the same
  float64 numpy: equal exactly.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from foundationpose_tpu.core import meshio as jmeshio, metrics as jmetrics  # noqa: E402
from foundationpose_tpu.core import poses as jposes  # noqa: E402
from foundationpose_tpu.io import datareader as jdr, file_loader as jfl  # noqa: E402
from foundationpose_tpu.io import masking as jmasking, pose6d as jpose6d  # noqa: E402
from foundationpose_tpu_torch.core import meshio, metrics, poses  # noqa: E402
from foundationpose_tpu_torch.io import datareader as dr, file_loader as fl  # noqa: E402
from foundationpose_tpu_torch.io import masking, png, pose6d  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _image(kind, shape=(29, 41)):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "gray16":
        a = rng.integers(0, 65536, shape).astype(np.uint16)
    else:
        ch = {"gray8": (), "rgb": (3,), "rgba": (4,)}[kind]
        a = rng.integers(0, 256, shape + ch).astype(np.uint8)
    # a smooth half, so that encoders pick Sub / Up / Average / Paeth rows
    a[: shape[0] // 2] = np.sort(a[: shape[0] // 2], axis=1)
    return a


KINDS = ("gray8", "gray16", "rgb", "rgba")


@pytest.mark.parametrize("kind", KINDS)
def test_png_round_trip(kind, tmp_path):
    a = _image(kind)
    png.write_png(tmp_path / "a.png", a)
    b = png.read_png(tmp_path / "a.png")
    assert b.dtype == a.dtype and np.array_equal(a, b)
    # what the port writes, cv2 and PIL read back the same
    c = cv2.imread(str(tmp_path / "a.png"), -1)
    assert np.array_equal(c if c.ndim == 2 else c[..., [2, 1, 0, 3][: c.shape[2]]], a)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), a)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [0, 1, 9])
def test_png_decodes_what_cv2_writes(kind, level):
    a = _image(kind)
    bgr = a if a.ndim == 2 else a[..., [2, 1, 0, 3][: a.shape[2]]]
    ok, buf = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    assert np.array_equal(png.decode_png(buf.tobytes()), a)


@pytest.mark.parametrize("kind", ["gray8", "rgb", "rgba", "palette", "palette4", "mask1bit"])
def test_png_decodes_what_pil_writes(kind):
    if kind.startswith("palette"):
        n = 4 if kind == "palette" else 16
        idx = RNG.integers(0, n, (31, 45)).astype(np.uint8)
        im = Image.fromarray(idx, mode="P")
        im.putpalette(RNG.integers(0, 256, 3 * n).tolist())
        kw = {"bits": 4} if kind == "palette4" else {}
    elif kind == "mask1bit":
        im, kw = Image.fromarray(RNG.integers(0, 2, (31, 45)).astype(bool)), {}
    else:
        im, kw = Image.fromarray(_image(kind)), {}
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=True, **kw)
    data = buf.getvalue()
    ref = Image.open(io.BytesIO(data))
    if kind.startswith("palette"):
        assert np.array_equal(png.decode_png(data, expand_palette=False), np.asarray(ref))
        assert np.array_equal(png.decode_png(data), np.asarray(ref.convert("RGB")))
        # cv2 expands a palette to BGR
        assert np.array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), -1)[..., ::-1],
                              png.decode_png(data))
    elif kind == "mask1bit":
        # gray below 8 bits is scaled to 0..255, as cv2 reads it
        out = png.decode_png(data)
        assert np.array_equal(out, cv2.imdecode(np.frombuffer(data, np.uint8), -1))
        assert np.array_equal(out > 0, np.asarray(ref))
    else:
        assert np.array_equal(png.decode_png(data), np.asarray(ref))


def test_png_rejects_what_it_does_not_read(tmp_path):
    rgb16 = RNG.integers(0, 65536, (8, 9, 3)).astype(np.uint16)
    ok, buf = cv2.imencode(".png", rgb16)
    with pytest.raises(ValueError, match="unsupported"):
        png.decode_png(buf.tobytes())
    im = Image.fromarray(_image("rgb"))
    b = io.BytesIO()
    im.save(b, format="PNG")
    data = bytearray(b.getvalue())
    data[40] ^= 0xFF  # inside IDAT: the chunk checksum no longer holds
    with pytest.raises(ValueError):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("src_hw", [(24, 32), (37, 53), (120, 161)])
def test_resize_matches_cv2(src_hw):
    h, w = src_hw
    for img in (RNG.integers(0, 256, (h, w, 3)).astype(np.uint8), RNG.random((h, w)) * 3,
                RNG.integers(0, 65535, (h, w)).astype(np.uint16)):
        for W, H in ((16, 12), (w * 2, h * 2), (w, h), (int(w * 0.37), int(h * 0.37))):
            assert np.array_equal(dr._resize_nearest(img, W, H),
                                  cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST))
    img = RNG.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for f in (0.5, 0.25, 0.37, 0.8, 1.5, 2.0, 1 / 3):
        a, b = dr._resize_linear(img, f, f), cv2.resize(img, None, fx=f, fy=f)
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1
        d = img[..., 0].astype(np.float64)
        Wd, Hd = dr._dst_size(w, f), dr._dst_size(h, f)
        assert np.array_equal(dr._resize_nearest(d, Wd, Hd, f, f),
                              cv2.resize(d, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST))


def test_imread_helpers_match_cv2_and_pil(tmp_path):
    for kind in KINDS:
        a = _image(kind)
        p = str(tmp_path / f"{kind}.png")
        png.write_png(p, a)
        assert np.array_equal(dr._imread(p), cv2.imread(p, -1))
        if kind != "gray16":
            assert np.array_equal(dr._imread_rgb(p), np.asarray(Image.open(p).convert("RGB")))
    with pytest.raises(FileNotFoundError):
        dr._imread(str(tmp_path / "missing.png"))


def test_metrics_match_jax_exactly():
    errs = RNG.uniform(0, 0.12, 57)
    for mx in (0.1, 0.05):
        assert metrics.compute_auc(errs, max_val=mx) == jmetrics.compute_auc(errs, max_val=mx)
    assert metrics.compute_auc([0.0, 0.0]) == jmetrics.compute_auc([0.0, 0.0])
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, :3, 3] = np.cumsum(RNG.normal(0, 0.01, (12, 3)), axis=0) + [0, 0, 0.6]
    pred = gt.copy()
    for i in range(12):
        w = RNG.normal(0, 0.02, 3)
        pred[i, :3, :3] = jposes.euler_matrix_np(*w)[:3, :3] @ gt[i, :3, :3]
    pred[:, :3, 3] += RNG.normal(0, 0.003, (12, 3))
    for align in (True, False):
        assert metrics.ate_rmse(pred, gt, align) == jmetrics.ate_rmse(pred, gt, align)
    for delta in (1, 3):
        assert metrics.rpe(pred, gt, delta) == jmetrics.rpe(pred, gt, delta)
    R, t = metrics.align_trajectory_se3(pred[:, :3, 3], gt[:, :3, 3])
    Rj, tj = jmetrics.align_trajectory_se3(pred[:, :3, 3], gt[:, :3, 3])
    assert np.array_equal(R, Rj) and np.array_equal(t, tj)


@pytest.mark.parametrize("info", [
    {},
    {"symmetries_discrete": [np.eye(4).reshape(-1).tolist(),
                             jposes.euler_matrix_np(0, np.pi, 0).reshape(-1).tolist()]},
    {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0.01]}]},
    {"symmetries_continuous": [{"axis": [1, 0, 0], "offset": [0, 0, 0]}],
     "symmetries_discrete": [np.eye(4).reshape(-1).tolist()]},
])
def test_symmetry_tfs_from_info_matches_jax(info):
    for step in (5, 30):
        assert np.array_equal(poses.symmetry_tfs_from_info(info, step),
                              jposes.symmetry_tfs_from_info(info, step))


# ---------------------------------------------------------------------------
# readers: a BOP tree (tests/test_datareader.py's layout) and a YCBInEOAT tree

H, W = 24, 32
K1 = np.array([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]])
K2 = np.array([[120.0, 0, 16], [0, 120.0, 12], [0, 0, 1]])


def _write_bop(root):
    scene = os.path.join(root, "test", "000048")
    for sub in ("rgb", "depth", "mask_visib", "mask"):
        os.makedirs(os.path.join(scene, sub))
    models = os.path.join(root, "ycbv_models", "models")
    os.makedirs(models)
    mesh = meshio.make_box((40.0, 30.0, 20.0))
    mesh.vertex_colors = RNG.integers(0, 256, (8, 3)).astype(np.uint8)
    info = {}
    for ob_id in range(1, 22):
        meshio.save_ply(os.path.join(models, f"obj_{ob_id:06d}.ply"), mesh)
        info[str(ob_id)] = {"diameter": 53.85}
    info["1"]["symmetries_continuous"] = [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]
    info["2"]["symmetries_discrete"] = [jposes.euler_matrix_np(0, 0, np.pi).reshape(-1).tolist()]
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    frames = [[(5, [0.0, 0.0, 500.0], (2, 2, 10, 10)), (5, [100.0, 50.0, 700.0], (14, 18, 22, 30)),
               (2, [-40.0, 0.0, 600.0], (12, 2, 20, 8))],
              [(5, [10.0, -10.0, 550.0], (4, 4, 12, 12))]]
    cam, gt = {}, {}
    for i, inst in enumerate(frames, start=1):
        cam[str(i)] = {"cam_K": (K1 if i == 1 else K2).reshape(-1).tolist(), "depth_scale": 0.1}
        cv2.imwrite(os.path.join(scene, "rgb", f"{i:06d}.png"),
                    RNG.integers(0, 256, (H, W, 3)).astype(np.uint8))
        depth = RNG.integers(3000, 9000, (H, W)).astype(np.uint16)
        depth[:3, :3] = 0  # holes
        cv2.imwrite(os.path.join(scene, "depth", f"{i:06d}.png"), depth)
        gt[str(i)] = []
        for pos, (ob_id, t_mm, (v0, u0, v1, u1)) in enumerate(inst):
            R = jposes.euler_matrix_np(0.1 * pos, 0.2, -0.3)[:3, :3]
            gt[str(i)].append({"obj_id": ob_id, "cam_R_m2c": R.reshape(-1).tolist(),
                               "cam_t_m2c": list(t_mm)})
            m = np.zeros((H, W), np.uint8)
            m[v0:v1, u0:u1] = 255
            for sub in ("mask_visib", "mask"):
                cv2.imwrite(os.path.join(scene, sub, f"{i:06d}_{pos:06d}.png"), m)
    with open(os.path.join(scene, "scene_camera.json"), "w") as f:
        json.dump(cam, f)
    with open(os.path.join(scene, "scene_gt.json"), "w") as f:
        json.dump(gt, f)
    with open(os.path.join(root, "keyframe.txt"), "w") as f:
        f.write("0048/000002\n")
    return scene


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("zfar", [np.inf, 0.6])
def test_bop_reader_matches_jax(tmp_path, zfar):
    scene = _write_bop(str(tmp_path / "bop" / "ycbv"))
    r, j = dr.get_bop_reader(scene, zfar=zfar), jdr.get_bop_reader(scene, zfar=zfar)
    assert type(r).__name__ == type(j).__name__ == "YcbVideoReader"
    assert len(r) == len(j) == 2 and r.get_video_id() == j.get_video_id()
    _same(r.symmetry_tfs, j.symmetry_tfs)
    _same(r.geometry_symmetry_info_table, j.geometry_symmetry_info_table)
    assert r.get_model_diameter(1) == j.get_model_diameter(1)
    _same(r.get_gt_mesh(5).vertices, j.get_gt_mesh(5).vertices)
    _same(r.get_gt_mesh(5).vertex_colors, j.get_gt_mesh(5).vertex_colors)
    for i in range(2):
        assert r.is_keyframe(i) == j.is_keyframe(i)
        _same(r.get_K(i), j.get_K(i))
        _same(r.get_color(i), j.get_color(i))
        _same(r.get_depth(i), j.get_depth(i))
        np.testing.assert_allclose(r.get_xyz_map(i), j.get_xyz_map(i), rtol=0, atol=1e-7)
        _same(r.get_instance_ids_in_image(i), j.get_instance_ids_in_image(i))
        for ob_id in set(r.get_instance_ids_in_image(i).tolist()):
            for kind in ("mask_visib", "mask"):
                _same(r.get_mask(i, ob_id, type=kind), j.get_mask(i, ob_id, type=kind))
            _same(r.get_gt_poses(i, ob_id), j.get_gt_poses(i, ob_id))
            m = r.get_mask(i, ob_id)
            _same(r.get_gt_pose(i, ob_id, mask=m), j.get_gt_pose(i, ob_id, mask=m))
            _same(r.get_gt_pose(i, ob_id), j.get_gt_pose(i, ob_id))


def test_bop_reader_resize_matches_jax(tmp_path):
    scene = _write_bop(str(tmp_path / "bop" / "ycbv"))
    r, j = dr.YcbVideoReader(scene), jdr.YcbVideoReader(scene)
    r.resize = j.resize = 0.5
    _same(r.get_K(0), j.get_K(0))
    _same(r.get_depth(0), j.get_depth(0))
    _same(r.get_mask(0, 2), j.get_mask(0, 2))
    a, b = r.get_color(0), j.get_color(0)
    assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1


def _write_ycbineoat(root, n=3, hw=(48, 64)):
    for sub in ("rgb", "depth", "masks", "annotated_poses", "masks_hand"):
        os.makedirs(os.path.join(root, sub))
    np.savetxt(os.path.join(root, "cam_K.txt"), [[300.0, 0, 32], [0, 300.0, 24], [0, 0, 1]])
    for i in range(n):
        name = f"{i:04d}.png"
        cv2.imwrite(os.path.join(root, "rgb", name),
                    RNG.integers(0, 256, hw + (3,)).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "depth", name),
                    RNG.integers(200, 1500, hw).astype(np.uint16))
        m = np.zeros(hw + (3,), np.uint8)
        m[10:30, 20:40, 1] = 255  # the mask in the second channel
        cv2.imwrite(os.path.join(root, "masks", name), m)
        cv2.imwrite(os.path.join(root, "masks_hand", name),
                    (RNG.random(hw) > 0.8).astype(np.uint8) * 255)
        if i != 1:  # one frame without an annotation
            np.savetxt(os.path.join(root, "annotated_poses", f"{i:04d}.txt"),
                       jposes.euler_matrix_np(0.1 * i, 0.2, 0.3))


@pytest.mark.parametrize("kw", [{}, {"shorter_side": 30}, {"downscale": 0.5, "zfar": 1.0}])
def test_ycbineoat_reader_matches_jax(tmp_path, kw):
    root = str(tmp_path / "bleach0")
    _write_ycbineoat(root)
    r, j = dr.YcbineoatReader(root, **kw), jdr.YcbineoatReader(root, **kw)
    assert len(r) == len(j) == 3 and (r.H, r.W) == (j.H, j.W)
    assert r.get_video_name() == j.get_video_name()
    _same(r.K, j.K)
    for i in range(3):
        _same(r.get_color(i), j.get_color(i))
        _same(r.get_depth(i), j.get_depth(i))
        _same(r.get_mask(i), j.get_mask(i))
        _same(r.get_occ_mask(i), j.get_occ_mask(i))
        np.testing.assert_allclose(r.get_xyz_map(i), j.get_xyz_map(i), rtol=0, atol=1e-7)
    # gt_pose_files lists the annotated frames only, in both packages
    _same([r.get_gt_pose(i) for i in range(2)], [j.get_gt_pose(i) for i in range(2)])
    assert r.get_gt_pose(2) is None and j.get_gt_pose(2) is None


# ---------------------------------------------------------------------------
# robot-camera loader, masks, pose conversion, mesh writers

ZED = """[LEFT_CAM_HD]
fx=700.5
fy=701.25
cx=640.1
cy=360.2

[LEFT_CAM_FHD1200]
fx=1050.5
fy=1051.0
cx=960.25
cy=600.75
k1=-0.01
"""


def test_file_loader_matches_jax(tmp_path):
    (tmp_path / "zed.conf").write_text(ZED)
    np.savetxt(tmp_path / "K.txt", K1)
    a, b = fl.FileLoader(), jfl.FileLoader()
    for name in ("zed.conf", "K.txt"):
        _same(a.load_camera_intrinsics(str(tmp_path / name)),
              b.load_camera_intrinsics(str(tmp_path / name)))
    _same(a.load_camera_intrinsics(str(tmp_path / "zed.conf"), "LEFT_CAM_HD"),
          b.load_camera_intrinsics(str(tmp_path / "zed.conf"), "LEFT_CAM_HD"))
    assert a.load_camera_intrinsics(str(tmp_path / "missing.txt")) is None
    rgb = RNG.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "rgb.png"), rgb[..., ::-1])
    _same(a.load_rgb_image_from_file(str(tmp_path / "rgb.png")),
          b.load_rgb_image_from_file(str(tmp_path / "rgb.png")))
    depth_mm = RNG.integers(0, 3000, (20, 30)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), depth_mm)
    np.save(tmp_path / "d.npy", depth_mm.astype(np.float32) / 1000)
    np.save(tmp_path / "d64.npy", depth_mm.astype(np.float64))
    for name in ("d.png", "d.npy", "d64.npy"):
        _same(a.load_depth_from_file(str(tmp_path / name)),
              b.load_depth_from_file(str(tmp_path / name)))
    assert a.load_depth_from_file(str(tmp_path / "none.png")) is None
    # an HTTP body as fetch_rgb_image / fetch_depth decode it (cv2.imdecode)
    body = png.encode_png(rgb)
    _same(a._imdecode(body, colour=True), cv2.imdecode(np.frombuffer(body, np.uint8),
                                                        cv2.IMREAD_COLOR))
    body = png.encode_png(depth_mm)
    _same(a._imdecode(body, colour=False), cv2.imdecode(np.frombuffer(body, np.uint8),
                                                         cv2.IMREAD_UNCHANGED))


def test_masks_match_jax(tmp_path):
    rle = {"size": (7, 5), "counts": [3, 4, 10, 2, 16]}
    _same(masking.rle_to_mask(rle), jmasking.rle_to_mask(rle))
    m = (RNG.random((20, 30)) > 0.5).astype(np.uint8) * 255
    cv2.imwrite(str(tmp_path / "m.png"), m)
    cv2.imwrite(str(tmp_path / "m3.png"), np.stack([m, m * 0, m], -1))
    np.save(tmp_path / "m.npy", m > 0)
    im = Image.fromarray((m > 0).astype(np.uint8), mode="P")
    im.putpalette([255, 255, 255, 0, 0, 0])  # index 0 is white: indices decide, as in PIL
    im.save(tmp_path / "p.png")
    for name in ("m.png", "m3.png", "m.npy", "p.png"):
        _same(masking.load_mask(str(tmp_path / name), shape=(20, 30)),
              jmasking.load_mask(str(tmp_path / name), shape=(20, 30)))
    with pytest.raises(ValueError):
        masking.load_mask(str(tmp_path / "m.png"), shape=(10, 10))


@pytest.mark.parametrize("euler", [(0.3, -0.2, 0.5), (0.0, np.pi / 2, 0.1), (0.2, -np.pi / 2, 0.0)])
def test_pose6d_matches_jax(euler):
    T = jposes.euler_matrix_np(*euler)
    T[:3, 3] = [0.1, -0.2, 0.7]
    for inch in (True, False):
        for deg in (True, False):
            assert (pose6d.PoseTransformer(inch, deg).transform_pose(T)
                    == jpose6d.PoseTransformer(inch, deg).transform_pose(T))


def test_mesh_writers_round_trip_like_jax(tmp_path):
    m = meshio.make_icosphere_mesh(1, 0.05)
    m.vertex_colors = RNG.integers(0, 256, (len(m.vertices), 3)).astype(np.uint8)
    meshio.save_ply(str(tmp_path / "a.ply"), m)
    jmeshio.save_ply(str(tmp_path / "b.ply"), jmeshio.Mesh(m.vertices, m.faces,
                                                           vertex_colors=m.vertex_colors))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    t = meshio.make_box((0.1, 0.2, 0.3))
    t.uv = RNG.random((8, 2))
    t.texture = RNG.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    meshio.save_obj(str(tmp_path / "t.obj"), t)
    for loaded in (meshio.load_mesh(str(tmp_path / "t.obj")),
                   jmeshio.load_mesh(str(tmp_path / "t.obj"))):
        # the OBJ reader unifies (v, vt) corners, so compare face by face
        np.testing.assert_allclose(loaded.vertices[loaded.faces], t.vertices[t.faces])
        np.testing.assert_allclose(loaded.uv[loaded.faces], t.uv[t.faces])
        assert np.array_equal(loaded.texture, t.texture)
