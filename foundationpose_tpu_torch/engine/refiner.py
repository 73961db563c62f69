"""Iterative render-and-compare pose refinement.

Counterpart of foundationpose_tpu/engine/refiner.py (``RefinerConfig``,
``PoseRefiner``, ``refine_once``, ``decode_delta``, ``_deepim_trans_delta``):
for each of ``iteration`` rounds, render all hypotheses into crops, run
RefineNet on [rendered | observed] 6-channel inputs, decode the predicted
delta (tracknet or deepim translation, axis-angle or 6d rotation) and apply
it egocentrically. The loop is an eager Python loop; the hypothesis axis is
the batch axis.
"""

from __future__ import annotations

import dataclasses

import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.engine.crop import make_crop_batch
from foundationpose_tpu_torch.models.refine_net import RefineNet


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """Decode configuration (reference defaults + normalize_xyz inputs)."""

    rot_rep: str = "axis_angle"  # or '6d'
    trans_rep: str = "tracknet"
    normalize_xyz: bool = True
    trans_normalizer: tuple = (0.019999999552965164,) * 3
    rot_normalizer: float = 0.3490658503988659  # 20 deg in rad
    crop_ratio: float = 1.2
    input_size: int = 160
    c_in: int = 6
    norm: str | None = None
    dtype: str = "bfloat16"
    # exact for closed CCW meshes; the estimator enables it when the mesh is
    # watertight (halves rasterizer work)
    backface_cull: bool = False


def net_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def seeded_init(make_net, seed: int):
    """Build a module with its random init drawn from ``seed`` without
    touching the global generator state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make_net()


class PoseRefiner:
    def __init__(self, config: RefinerConfig = RefinerConfig(), device=None, seed=0):
        self.cfg = config
        self.device = resolve_device(device)
        self.net = seeded_init(
            lambda: RefineNet(
                c_in=config.c_in, rot_rep=config.rot_rep, norm=config.norm,
                dtype=net_dtype(config.dtype),
            ),
            seed,
        ).to(self.device).eval()

    @torch.no_grad()
    def refine(self, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
               iteration=5, out_size=None, gate_px=0):
        """poses: (N,4,4) -> refined (N,4,4) float32 tensor on the device."""
        poses = geo.as_f32(poses, self.device)
        for _ in range(int(iteration)):
            poses = refine_once(
                self.net, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                cfg=self.cfg, out_size=out_size, gate_px=gate_px,
            )
        return poses


def refine_inputs(mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                  *, cfg: RefinerConfig, out_size=None, gate_px=0):
    """The crop batch RefineNet reads for these poses (``inputA``, ``inputB``,
    ``tf_to_crops``, ...)."""
    return make_crop_batch(
        mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
        crop_ratio=cfg.crop_ratio, out_size=int(out_size or cfg.input_size),
        normalize_xyz=cfg.normalize_xyz, z_invalid_thres=0.001,
        backface_cull=cfg.backface_cull, gate_px=int(gate_px),
    )


def apply_net_output(out, poses, K, tf_to_crops, mesh_diameter,
                     *, cfg: RefinerConfig, out_size=None):
    """Decode RefineNet's output for ``poses`` and apply it egocentrically."""
    poses = geo.as_f32(poses, out["trans"].device)
    trans_delta, rot_mat_delta = decode_delta(
        out, cfg, mesh_diameter, poses=poses, K=geo.as_f32(K, poses.device),
        tf_to_crops=tf_to_crops, input_size=int(out_size or cfg.input_size),
    )
    return geo.egocentric_delta_pose_to_pose(poses, trans_delta, rot_mat_delta)


def refine_once(net, mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                *, cfg: RefinerConfig, out_size=None, gate_px=0):
    data = refine_inputs(mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
                         cfg=cfg, out_size=out_size, gate_px=gate_px)
    out = net(data["inputA"], data["inputB"])
    return apply_net_output(out, poses, K, data["tf_to_crops"], mesh_diameter,
                            cfg=cfg, out_size=out_size)


def _deepim_trans_delta(out_trans, poses, K, tf_to_crops, input_size):
    """DeepIM-style translation decode: the net predicts a crop-space uv
    offset (in units of the crop width) and a relative depth; unproject
    through the crop transform and K to get the camera-space centre delta."""
    t = poses[:, :3, 3]  # (N,3)
    z_pred = out_trans[:, 2] * t[:, 2]
    uv = t @ K.T
    uv = uv / uv[:, 2:3]
    uv_crop = torch.einsum("nij,nj->ni", tf_to_crops, uv)[:, :2]
    uv_pred_crop = uv_crop + out_trans[:, :2] * input_size
    inv_tf = torch.linalg.inv(tf_to_crops)
    ones = torch.ones((out_trans.shape[0], 1), dtype=torch.float32, device=t.device)
    uv_pred = torch.einsum(
        "nij,nj->ni", inv_tf, torch.cat([uv_pred_crop, ones], dim=-1)
    )[:, :2]
    ray = torch.cat([uv_pred, ones], dim=-1) @ torch.linalg.inv(K).T
    center_pred = ray * z_pred[:, None]
    return center_pred - t


def decode_delta(out, cfg: RefinerConfig, mesh_diameter, *, poses=None, K=None,
                 tf_to_crops=None, input_size=None):
    """Net outputs -> (trans_delta (N,3), rot_mat_delta (N,3,3))."""
    if cfg.trans_rep == "tracknet":
        if cfg.normalize_xyz:
            trans_delta = out["trans"] * (mesh_diameter / 2.0)
        else:
            # column by column: a (1,3) tensor of the normalizer would be an
            # upload, and an upload makes the host wait for the card
            th = torch.tanh(out["trans"])
            trans_delta = torch.stack(
                [th[:, i] * float(tn) for i, tn in enumerate(cfg.trans_normalizer)], dim=-1)
    elif cfg.trans_rep == "deepim":
        trans_delta = _deepim_trans_delta(
            out["trans"], poses, K, tf_to_crops,
            input_size if input_size is not None else cfg.input_size,
        )
        if cfg.normalize_xyz:
            # the reference applies the diameter scaling to ALL trans reps,
            # deepim included; mirrored for checkpoint parity
            trans_delta = trans_delta * (mesh_diameter / 2.0)
    else:
        raise ValueError(cfg.trans_rep)

    if cfg.rot_rep == "axis_angle":
        rot_mat_delta = geo.so3_exp_map(
            torch.tanh(out["rot"]) * cfg.rot_normalizer
        ).transpose(1, 2)
    elif cfg.rot_rep == "6d":
        rot_mat_delta = geo.rotation_6d_to_matrix(out["rot"]).transpose(1, 2)
    else:
        raise ValueError(cfg.rot_rep)
    return trans_delta, rot_mat_delta
