"""Hypothesis scoring.

Counterpart of foundationpose_tpu/engine/scorer.py (``ScorerConfig``,
``PoseScorer``, ``HybridScorer``): one cross-pose-attention forward over all
L hypotheses of a frame; the hybrid adds ``weight x`` the geometric score
(depth consistency + normal agreement + silhouette edges) to the net logit —
geometric veto on gross wrong basins, ScoreNet on fine ranking.
"""

from __future__ import annotations

import dataclasses

import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.engine.crop import make_crop_batch
from foundationpose_tpu_torch.engine.geometric import GeometricConfig, geo_score
from foundationpose_tpu_torch.engine.refiner import net_dtype, seeded_init
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    normalize_xyz: bool = True
    crop_ratio: float = 1.2
    input_size: int = 160
    c_in: int = 6
    norm: str | None = None
    dtype: str = "bfloat16"
    # residual attention wrappers for synthetically-trained nets; False =
    # exact reference forward for imported checkpoints
    residual_attn: bool = False
    # exact for closed CCW meshes; the estimator enables it when the mesh is
    # watertight
    backface_cull: bool = False


class PoseScorer:
    def __init__(self, config: ScorerConfig = ScorerConfig(), device=None, seed=0):
        self.cfg = config
        self.device = resolve_device(device)
        self.net = seeded_init(
            lambda: ScoreNetMultiPair(
                c_in=config.c_in, norm=config.norm, dtype=net_dtype(config.dtype),
                residual_attn=config.residual_attn,
            ),
            seed,
        ).to(self.device).eval()

    @torch.no_grad()
    def score(self, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
              out_size=None, gate_px=0, device_mesh=None):
        """poses: (N,4,4) -> scores (N,) float32 tensor on the device. With a
        ``device_mesh`` (first axis; N splits evenly over it) each process
        renders and encodes its slice of the hypotheses, the pair features
        are gathered in order, and every process ranks all N."""
        cfg = self.cfg
        n = poses.shape[0]
        if device_mesh is not None:
            from foundationpose_tpu_torch.parallel.mesh import shard_batch

            poses = shard_batch(device_mesh, poses, device_mesh.axis_names[0])
        data = make_crop_batch(
            mesh_tensors, poses, K, rgb, xyz_map, mesh_diameter,
            crop_ratio=cfg.crop_ratio, out_size=int(out_size or cfg.input_size),
            normalize_xyz=cfg.normalize_xyz,
            z_invalid_thres=0.1,  # scorer-dataset semantics
            backface_cull=cfg.backface_cull, gate_px=int(gate_px),
        )
        if device_mesh is None:
            return self.net(data["inputA"], data["inputB"], n)["score_logit"].reshape(-1)
        from foundationpose_tpu_torch.parallel.mesh import all_gather_rows

        feats = self.net.pair_features(data["inputA"], data["inputB"])
        # gathered in float32: exact for bf16 features, and both backends reduce it
        feats = all_gather_rows(device_mesh, feats.float(),
                                device_mesh.axis_names[0]).to(feats.dtype)
        return self.net.rank(feats, n)["score_logit"].reshape(-1)



class HybridScorer:
    """ScoreNet ranking + geometric depth-consistency veto:
    ``learned score + weight * geo score``. Same ``score`` interface as
    ``PoseScorer``, so it serves register and multi-hypothesis tracking."""

    def __init__(self, learned: PoseScorer, geo_config=None, weight=2.0):
        self.learned = learned
        self.geo_cfg = geo_config or GeometricConfig(
            input_size=learned.cfg.input_size,
            backface_cull=learned.cfg.backface_cull,
        )
        self.weight = float(weight)

    # the estimator flips backface culling via dataclasses.replace on .cfg;
    # expose the learned scorer's cfg and mirror changes into the geo cfg
    @property
    def cfg(self):
        return self.learned.cfg

    @cfg.setter
    def cfg(self, value):
        self.learned.cfg = value
        self.geo_cfg = dataclasses.replace(
            self.geo_cfg, backface_cull=value.backface_cull
        )

    @property
    def device(self):
        return self.learned.device

    @property
    def net(self):
        return self.learned.net

    def score(self, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
              out_size=None, gate_px=0, device_mesh=None):
        s = self.learned.score(mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter,
                               out_size=out_size, gate_px=gate_px, device_mesh=device_mesh)
        g = geo_score(self.geo_cfg, mesh_tensors, poses, K, rgb, xyz_map,
                      mesh_diameter, gate_px=gate_px, device_mesh=device_mesh)
        return s + self.weight * g

