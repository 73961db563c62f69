"""Dataset readers: BOP suite (YCB-V, LINEMOD(-O), T-LESS, HB, ITODD, IC-BIN,
TUD-L) and YCBInEOAT tracking videos.

The port's own copy of foundationpose_tpu/io/datareader.py (reference
src/datareader.py: factory :24-61, BOP base :183-394, per-dataset subclasses
:397-639): same directory layouts, unit conventions (BOP poses/meshes in mm
-> m, depth png/1000 * depth_scale), mask naming, IoU-based GT
disambiguation for multi-instance scenes, and the YCB-V geometric-symmetry
overrides.

Images are read without cv2 or PIL: PNG through the port's codec
(``io/png.py``), with cv2's conventions kept where the JAX package reads
with cv2 (``_imread``: colour in BGR order, palette expanded) and PIL's where
it reads with PIL (``_imread_rgb``). Other formats (``.jpg`` colour, ``.tif``
gray) import PIL or cv2 when read and raise, naming the package, without it.
``cv2.resize`` is reproduced in numpy: nearest neighbour bit for bit, bilinear
on uint8 within one grey level (cv2 rounds in 11-bit fixed point).
"""

from __future__ import annotations

import glob
import importlib
import json
import logging
import os

import numpy as np
import torch

from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.core.geometry import depth2xyzmap
from foundationpose_tpu_torch.core.poses import euler_matrix_np, symmetry_tfs_from_info
from foundationpose_tpu_torch.io import png

BOP_DIR = os.getenv("BOP_DIR", "")
YCB_VIDEO_DIR = os.getenv("YCB_VIDEO_DIR", "")


def import_optional(name):
    """Import a package that only some image formats need; raise an
    ImportError that names it when it is missing."""
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"this file needs the {name.split('.')[0]!r} package, which is not installed "
            "(PNG images are read without it)") from e


def _is_png(path):
    return str(path).lower().endswith(".png")


def _imread(path):
    """``cv2.imread(path, -1)``: gray as (H,W) uint8/uint16, colour as BGR(A)."""
    if _is_png(path):
        img = png.read_png(path)
        return img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img
    img = import_optional("cv2").imread(path, -1)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _imread_rgb(path):
    """``np.asarray(PIL.Image.open(path).convert("RGB"))``."""
    if not _is_png(path):
        return np.asarray(import_optional("PIL.Image").open(path).convert("RGB"))
    img = png.read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit image is not a colour image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _dst_size(n, scale):
    return int(np.rint(n * scale))  # cv2 saturate_cast: round half to even


def _resize_nearest(img, W, H, fx=None, fy=None):
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)``: source
    index floor(x / scale) in float64, clamped; the scale is dst / src, or
    ``fx`` / ``fy`` where cv2 was given factors instead of a size."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    xs = np.floor(np.arange(W) * (1.0 / (fx or W / w))).astype(np.int64)
    ys = np.floor(np.arange(H) * (1.0 / (fy or H / h))).astype(np.int64)
    return img[np.minimum(ys, h - 1)[:, None], np.minimum(xs, w - 1)[None, :]]


def _linear_taps(n_dst, n_src, scale):
    """cv2's INTER_LINEAR source positions: (x + 0.5) / scale - 0.5 in
    float32, clamped to the border with weight 0 beyond it."""
    f = ((np.arange(n_dst) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w1 = (f - i0).astype(np.float64)
    low, high = i0 < 0, i0 >= n_src - 1
    i0 = np.where(low, 0, np.where(high, n_src - 1, i0))
    w1 = np.where(low | high, 0.0, w1)
    return i0, np.minimum(i0 + 1, n_src - 1), w1


def _resize_linear(img, fx, fy):
    """``cv2.resize(img, None, fx=fx, fy=fy)`` (bilinear) on uint8 images:
    the same taps, interpolated in float64 and rounded (cv2's 11-bit fixed
    point can differ by one grey level)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    x0, x1, wx = _linear_taps(_dst_size(w, fx), w, fx)
    y0, y1, wy = _linear_taps(_dst_size(h, fy), h, fy)
    a = img.astype(np.float64)
    wx = wx.reshape((1, -1) + (1,) * (img.ndim - 2))
    wy = wy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = a[:, x0] * (1 - wx) + a[:, x1] * wx
    out = rows[y0] * (1 - wy) + rows[y1] * wy
    return np.clip(np.rint(out), 0, 255).astype(img.dtype)


def _xyz_map(depth, K):
    """Host-side (H,W,3) float32 xyz map through the port's ``depth2xyzmap``
    (float32, as the JAX package computes it)."""
    return depth2xyzmap(torch.from_numpy(np.asarray(depth, np.float32)),
                        torch.from_numpy(np.asarray(K, np.float32))).numpy()


def get_bop_reader(video_dir, zfar=np.inf):
    """Factory (reference datareader.py:45-61)."""
    if "ycbv" in video_dir or "YCB" in video_dir:
        return YcbVideoReader(video_dir, zfar=zfar)
    if "lmo" in video_dir or "LINEMOD-O" in video_dir:
        return LinemodOcclusionReader(video_dir, zfar=zfar)
    if "tless" in video_dir or "TLESS" in video_dir:
        return TlessReader(video_dir, zfar=zfar)
    if "hb" in video_dir:
        return HomebrewedReader(video_dir, zfar=zfar)
    if "tudl" in video_dir:
        return TudlReader(video_dir, zfar=zfar)
    if "icbin" in video_dir:
        return IcbinReader(video_dir, zfar=zfar)
    if "itodd" in video_dir:
        return ItoddReader(video_dir, zfar=zfar)
    raise RuntimeError(f"no reader for {video_dir}")


def get_bop_video_dirs(dataset, bop_dir=None):
    """(reference datareader.py:64-81)"""
    bop = bop_dir or BOP_DIR
    sub = {
        "ycbv": "ycbv/test/*",
        "lmo": "lmo/lmo_test_bop19/test/*",
        "tless": "tless/tless_test_primesense_bop19/test_primesense/*",
        "hb": "hb/hb_test_primesense_bop19/test_primesense/*",
        "tudl": "tudl/tudl_test_bop19/test/*",
        "icbin": "icbin/icbin_test_bop19/test/*",
        "itodd": "itodd/itodd_test_bop19/test/*",
    }[dataset]
    return sorted(glob.glob(f"{bop}/{sub}"))


class BopBaseReader:
    """Common BOP scene layout: rgb|gray/, depth/, mask[_visib]/,
    scene_camera.json (per-frame K + depth_scale), scene_gt.json."""

    dataset_name: str | None = None

    def __init__(self, base_dir, zfar=np.inf, resize=1):
        self.base_dir = base_dir
        self.resize = resize
        self.zfar = zfar
        self.color_files = sorted(glob.glob(f"{base_dir}/rgb/*"))
        if not self.color_files:
            self.color_files = sorted(glob.glob(f"{base_dir}/gray/*"))

        with open(f"{base_dir}/scene_camera.json") as f:
            info = json.load(f)
        self.K_table = {}
        self.bop_depth_scale = 1.0
        for k, v in info.items():
            self.K_table[f"{int(k):06d}"] = np.array(v["cam_K"]).reshape(3, 3)
            self.bop_depth_scale = v["depth_scale"]

        gt_file = f"{base_dir}/scene_gt.json"
        if os.path.exists(gt_file):
            with open(gt_file) as f:
                self.scene_gt = json.load(f)
            assert len(self.scene_gt) == len(self.color_files), (
                f"scene_gt has {len(self.scene_gt)} frames but found "
                f"{len(self.color_files)} images"
            )
        else:
            self.scene_gt = None
        self.scene_ob_ids_dict = None
        self.make_id_strs()

    # -- frame identity ------------------------------------------------
    def make_id_strs(self):
        self.id_strs = [
            os.path.basename(f).split(".")[0] for f in self.color_files
        ]

    def __len__(self):
        return len(self.color_files)

    def get_video_id(self):
        return int(self.base_dir.rstrip("/").split("/")[-1])

    def get_K(self, i_frame):
        K = self.K_table[self.id_strs[i_frame]].copy()
        if self.resize != 1:
            K[:2, :2] *= self.resize
        return K

    def make_scene_ob_ids_dict(self, bop_dir=None):
        """Object ids per frame from test_targets_bop19.json (for datasets
        without scene_gt, reference datareader.py:211-220)."""
        bop = bop_dir or BOP_DIR
        path = f"{bop}/{self.dataset_name}/test_targets_bop19.json"
        if not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        self.scene_ob_ids_dict = {}
        for d in data:
            if d["scene_id"] == self.get_video_id():
                id_str = f"{d['im_id']:06d}"
                self.scene_ob_ids_dict.setdefault(id_str, [])
                self.scene_ob_ids_dict[id_str] += [d["obj_id"]] * d["inst_count"]

    def get_instance_ids_in_image(self, i_frame):
        if self.scene_gt is not None:
            name = int(self.id_strs[i_frame])
            return np.asarray(
                [k["obj_id"] for k in self.scene_gt[str(name)]]
            )
        if self.scene_ob_ids_dict is not None:
            return np.asarray(self.scene_ob_ids_dict[self.id_strs[i_frame]])
        mask_dir = os.path.dirname(self.color_files[0]).replace("rgb", "mask_visib")
        files = sorted(glob.glob(f"{mask_dir}/{self.id_strs[i_frame]}_*.png"))
        return np.asarray(
            [int(os.path.basename(f).split(".")[0].split("_")[1]) for f in files]
        )

    # -- pixels --------------------------------------------------------
    def get_color(self, i):
        color = _imread_rgb(self.color_files[i])
        if self.resize != 1:
            color = _resize_linear(color, self.resize, self.resize)
        return color

    def get_depth(self, i):
        depth_file = self.color_files[i].replace("rgb", "depth").replace("gray", "depth")
        depth = _imread(depth_file).astype(np.float64) * 1e-3 * self.bop_depth_scale
        if self.resize != 1:
            depth = _resize_nearest(depth, _dst_size(depth.shape[1], self.resize),
                                    _dst_size(depth.shape[0], self.resize),
                                    self.resize, self.resize)
        depth[(depth < 0.001) | (depth > self.zfar)] = 0
        return depth

    def get_xyz_map(self, i):
        return _xyz_map(self.get_depth(i), self.get_K(i))

    def get_mask(self, i_frame, ob_id, type="mask_visib"):
        """type: 'mask_visib' (visible part) or 'mask' (full projection)."""
        if self.scene_gt is None:
            raise RuntimeError("masks by ob_id require scene_gt")
        name = int(self.id_strs[i_frame])
        pos = 0
        for k in self.scene_gt[str(name)]:
            if k["obj_id"] == ob_id:
                break
            pos += 1
        mask_file = f"{self.base_dir}/{type}/{name:06d}_{pos:06d}.png"
        if not os.path.exists(mask_file):
            logging.info("%s not found", mask_file)
            return None
        mask = _imread(mask_file)
        if self.resize != 1:
            mask = _resize_nearest(mask, _dst_size(mask.shape[1], self.resize),
                                   _dst_size(mask.shape[0], self.resize),
                                   self.resize, self.resize)
        return mask > 0

    # -- ground truth --------------------------------------------------
    def get_gt_poses(self, i_frame, ob_id):
        name = int(self.id_strs[i_frame])
        out = []
        for k in self.scene_gt[str(name)]:
            if k["obj_id"] == ob_id:
                cur = np.eye(4)
                cur[:3, :3] = np.array(k["cam_R_m2c"]).reshape(3, 3)
                cur[:3, 3] = np.array(k["cam_t_m2c"]) / 1e3
                out.append(cur)
        return np.asarray(out).reshape(-1, 4, 4)

    def get_gt_pose(self, i_frame, ob_id, mask=None):
        """Multi-instance scenes: pick the GT instance whose visible mask has
        max IoU with ``mask`` (reference datareader.py:347-377)."""
        name = int(self.id_strs[i_frame])
        ob_in_cam = np.eye(4)
        best_iou = -np.inf
        for i_k, k in enumerate(self.scene_gt[str(name)]):
            if k["obj_id"] != ob_id:
                continue
            cur = np.eye(4)
            cur[:3, :3] = np.array(k["cam_R_m2c"]).reshape(3, 3)
            cur[:3, 3] = np.array(k["cam_t_m2c"]) / 1e3
            if mask is None:
                return cur
            gt_mask = _imread(
                f"{self.base_dir}/mask_visib/{self.id_strs[i_frame]}_{i_k:06d}.png"
            ).astype(bool)
            inter = (gt_mask & mask.astype(bool)).sum()
            union = (gt_mask | mask.astype(bool)).sum()
            iou = inter / max(union, 1)
            if iou > best_iou:
                best_iou = iou
                ob_in_cam = cur
        return ob_in_cam

    # -- models --------------------------------------------------------
    def get_gt_mesh_file(self, ob_id):
        raise NotImplementedError

    def get_gt_mesh(self, ob_id):
        mesh = meshio.load_mesh(self.get_gt_mesh_file(ob_id))
        mesh.vertices = mesh.vertices * 1e-3  # BOP models are mm
        return mesh

    def get_model_diameter(self, ob_id):
        d = os.path.dirname(self.get_gt_mesh_file(self.ob_ids[0]))
        with open(f"{d}/models_info.json") as f:
            info = json.load(f)
        return info[str(ob_id)]["diameter"] / 1e3

    def load_symmetry_tfs(self):
        d = os.path.dirname(self.get_gt_mesh_file(self.ob_ids[0]))
        info_file = f"{d}/models_info.json"
        self.symmetry_tfs = {}
        self.symmetry_info_table = {}
        if not os.path.exists(info_file):
            for ob_id in self.ob_ids:
                self.symmetry_tfs[ob_id] = np.eye(4)[None]
                self.symmetry_info_table[ob_id] = {}
            self.geometry_symmetry_info_table = dict(self.symmetry_info_table)
            return
        with open(info_file) as f:
            info = json.load(f)
        for ob_id in self.ob_ids:
            self.symmetry_info_table[ob_id] = info[str(ob_id)]
            self.symmetry_tfs[ob_id] = symmetry_tfs_from_info(
                info[str(ob_id)], rot_angle_discrete=5
            )
        self.geometry_symmetry_info_table = {
            k: dict(v) for k, v in self.symmetry_info_table.items()
        }


class LinemodOcclusionReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "lmo"
        self.K = list(self.K_table.values())[0]
        self.ob_ids = [1, 5, 6, 8, 9, 10, 11, 12]
        self.ob_id_to_names = {
            1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "water_pour",
            6: "cat", 7: "cup", 8: "driller", 9: "duck", 10: "eggbox",
            11: "glue", 12: "holepuncher", 13: "iron", 14: "lamp", 15: "phone",
        }
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{BOP_DIR}/{self.dataset_name}/models/obj_{ob_id:06d}.ply"


class LinemodReader(LinemodOcclusionReader):
    def __init__(self, base_dir, zfar=np.inf, split=None):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "lm"
        if split is not None:
            split_file = (
                f"{os.path.dirname(self.base_dir)}/../splits/"
                f"{self.get_video_id():02d}/{split}.txt"
            )
            if os.path.exists(split_file):
                with open(split_file) as f:
                    ids = [int(line) for line in f.read().splitlines()]
                self.color_files = [
                    f"{self.base_dir}/rgb/{i:06d}.png" for i in ids
                ]
                self.make_id_strs()
        # exclude bowl (3) and mug/cup (7): not in LINEMOD eval protocol
        self.ob_ids = np.setdiff1d(np.arange(1, 16), np.array([7, 3])).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        root = self.base_dir
        while True:
            cand = f"{root}/lm_models/models/obj_{ob_id:06d}.ply"
            if os.path.exists(os.path.dirname(cand)):
                return cand
            parent = os.path.abspath(f"{root}/../")
            if parent == root:
                return cand
            root = parent

    def get_reconstructed_mesh(self, ob_id, ref_view_dir):
        return meshio.load_mesh(
            os.path.abspath(f"{ref_view_dir}/ob_{ob_id:07d}/model/model.obj")
        )


class YcbVideoReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "ycbv"
        self.K = list(self.K_table.values())[0]
        self.ob_ids = np.arange(1, 22).astype(int).tolist()
        models_dir = f"{YCB_VIDEO_DIR}/models/" if YCB_VIDEO_DIR else None
        self.ob_id_to_names = {}
        self.name_to_ob_id = {}
        if models_dir and os.path.isdir(models_dir):
            names = sorted(os.listdir(models_dir))
            for i, ob_id in enumerate(self.ob_ids):
                if i < len(names):
                    self.ob_id_to_names[ob_id] = names[i]
                    self.name_to_ob_id[names[i]] = ob_id
        keyframe_file = f"{self.base_dir}/../../keyframe.txt"
        self.keyframe_lines = []
        if "BOP" not in self.base_dir and os.path.exists(keyframe_file):
            with open(keyframe_file) as f:
                self.keyframe_lines = f.read().splitlines()

        self.load_symmetry_tfs()
        # Geometric (not texture) symmetries for scoring, reference
        # datareader.py:483-507
        for ob_id in self.ob_ids:
            if ob_id in [1, 4, 6, 18]:  # cylinders
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                    "symmetries_discrete": euler_matrix_np(0, np.pi, 0)
                    .reshape(1, 4, 4)
                    .tolist(),
                }
            elif ob_id in [13]:
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                }
            elif ob_id in [2, 3, 9, 21]:  # rectangular boxes
                tfs = [
                    euler_matrix_np(rx, ry, rz)
                    for rz in [0, np.pi]
                    for rx in [0, np.pi]
                    for ry in [0, np.pi]
                ]
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_discrete": np.asarray(tfs).reshape(-1, 4, 4).tolist(),
                }

    def get_gt_mesh_file(self, ob_id):
        return os.path.abspath(
            f"{self.base_dir}/../../ycbv_models/models/obj_{ob_id:06d}.ply"
        )

    def get_reconstructed_mesh(self, ob_id, ref_view_dir):
        return meshio.load_mesh(
            os.path.abspath(f"{ref_view_dir}/ob_{ob_id:07d}/model/model.obj")
        )

    def is_keyframe(self, i):
        frame_id = int(self.id_strs[i])
        key = f"{self.get_video_id():04d}/{frame_id:06d}"
        return key in self.keyframe_lines


class TlessReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "tless"
        self.ob_ids = np.arange(1, 31).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../models_cad/obj_{ob_id:06d}.ply"

    def get_gt_mesh(self, ob_id):
        mesh = super().get_gt_mesh(ob_id)
        # CAD models are colorless: flat gray like the reference (:578)
        mesh.vertex_colors = np.full((len(mesh.vertices), 3), 200, np.uint8)
        return mesh


class HomebrewedReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "hb"
        self.ob_ids = np.arange(1, 34).astype(int).tolist()
        self.load_symmetry_tfs()
        self.make_scene_ob_ids_dict()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../hb_models/models/obj_{ob_id:06d}.ply"

    def get_gt_pose(self, i_frame, ob_id, mask=None):
        logging.info("HomeBrewed test split has no GT poses")
        return np.eye(4)


class ItoddReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "itodd"
        self.ob_ids = np.arange(1, 29).astype(int).tolist()
        self.load_symmetry_tfs()
        self.make_scene_ob_ids_dict()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../itodd_models/models/obj_{ob_id:06d}.ply"


class IcbinReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "icbin"
        self.ob_ids = np.arange(1, 3).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../icbin_models/models/obj_{ob_id:06d}.ply"


class TudlReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "tudl"
        self.ob_ids = np.arange(1, 4).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../tudl_models/models/obj_{ob_id:06d}.ply"


class YcbineoatReader:
    """YCBInEOAT tracking videos (reference datareader.py:85-180): rgb/,
    depth/ (mm png), masks/, annotated_poses/, cam_K.txt."""

    def __init__(self, video_dir, downscale=1, shorter_side=None, zfar=np.inf):
        self.video_dir = video_dir
        self.zfar = zfar
        self.downscale = downscale
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.png"))
        self.K = np.loadtxt(f"{video_dir}/cam_K.txt").reshape(3, 3)
        self.id_strs = [
            os.path.basename(f).replace(".png", "") for f in self.color_files
        ]
        first = _imread_rgb(self.color_files[0])
        self.H, self.W = first.shape[:2]
        if shorter_side is not None:
            self.downscale = shorter_side / min(self.H, self.W)
        self.H = int(self.H * self.downscale)
        self.W = int(self.W * self.downscale)
        self.K = self.K.copy()
        self.K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{video_dir}/annotated_poses/*"))
        self.videoname_to_object = {
            "bleach0": "021_bleach_cleanser",
            "bleach_hard_00_03_chaitanya": "021_bleach_cleanser",
            "cracker_box_reorient": "003_cracker_box",
            "cracker_box_yalehand0": "003_cracker_box",
            "mustard0": "006_mustard_bottle",
            "mustard_easy_00_02": "006_mustard_bottle",
            "sugar_box1": "004_sugar_box",
            "sugar_box_yalehand0": "004_sugar_box",
            "tomato_soup_can_yalehand0": "005_tomato_soup_can",
        }

    def __len__(self):
        return len(self.color_files)

    def get_video_name(self):
        return self.video_dir.rstrip("/").split("/")[-1]

    def get_gt_pose(self, i):
        try:
            return np.loadtxt(self.gt_pose_files[i]).reshape(4, 4)
        except Exception:
            logging.info("GT pose not found, return None")
            return None

    def get_color(self, i):
        color = _imread_rgb(self.color_files[i])
        return _resize_nearest(color, self.W, self.H)

    def get_mask(self, i):
        mask = _imread(self.color_files[i].replace("rgb", "masks"))
        if mask.ndim == 3:
            for c in range(3):
                if mask[..., c].sum() > 0:
                    mask = mask[..., c]
                    break
        mask = _resize_nearest(mask, self.W, self.H)
        return (mask > 0).astype(np.uint8)

    def get_depth(self, i):
        depth = _imread(self.color_files[i].replace("rgb", "depth")).astype(np.float64) / 1e3
        depth = _resize_nearest(depth, self.W, self.H)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0
        return depth

    def get_xyz_map(self, i):
        return _xyz_map(self.get_depth(i), self.K)

    def get_occ_mask(self, i):
        occ = np.zeros((self.H, self.W), dtype=bool)
        for sub in ("masks_hand", "masks_hand_right"):
            f = self.color_files[i].replace("rgb", sub)
            if os.path.exists(f):
                m = _imread(f)
                occ |= _resize_nearest((m > 0).astype(np.uint8), self.W, self.H) > 0
        return occ.astype(np.uint8)

    def get_gt_mesh(self):
        name = self.videoname_to_object[self.get_video_name()]
        return meshio.load_mesh(
            f"{YCB_VIDEO_DIR}/models/{name}/textured_simple.obj"
        )
