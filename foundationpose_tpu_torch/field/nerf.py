"""Neural object field model: positional encoder + SDF / colour MLP +
per-frame learnable pose corrections and latent codes.

Counterpart of foundationpose_tpu/field/nerf.py (``NeRFSmall``,
``ObjectField``), after the reference's NeRFSmall (nerf_helpers.py:277-355:
2-layer sigma net 64 wide -> 1 SDF + 15 geometry features with a +0.1 bias on
the last layer, 3-layer colour net), FeatureArray (:25-41) and PoseArray
(:44-64: tanh-bounded 6-DoF se3 deltas, frame 0 pinned to the identity).

OpenCV camera convention (z forward); poses are cam-in-object in the
normalised [-1,1] space. Parameter names follow the JAX package's tree
(``grid``, ``mlp.sigma_l`` / ``mlp.color_l``, ``feature_array``,
``pose_array``) so ``models/convert.py`` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.field.encoders import (
    TriplaneEncoder,
    clip,
    freq_encode,
    freq_out_dim,
    sh_encode,
    sh_out_dim,
    triplane_out_dim,
)
from foundationpose_tpu_torch.models.convert import flax_init
from foundationpose_tpu_torch.ops.hashgrid import HashGridEncoder


class NeRFSmall(nn.Module):
    """Dense layers drawn as flax's ``Dense`` draws them (``flax_init``:
    lecun-normal kernels, zero biases), the last sigma bias 0.1."""

    def __init__(self, pos_dim, view_dim, num_layers=2, hidden_dim=64, geo_feat_dim=15,
                 num_layers_color=3, hidden_dim_color=64, seed=0):
        super().__init__()
        self.num_layers, self.num_layers_color = num_layers, num_layers_color
        d = pos_dim
        for l in range(num_layers):
            out = 1 + geo_feat_dim if l == num_layers - 1 else hidden_dim
            setattr(self, f"sigma_{l}", nn.Linear(d, out))
            d = out
        d = view_dim + geo_feat_dim
        for l in range(num_layers_color):
            out = 3 if l == num_layers_color - 1 else hidden_dim_color
            setattr(self, f"color_{l}", nn.Linear(d, out))
            d = out
        flax_init(self, seed)
        with torch.no_grad():
            # +0.1 bias: encourage positive SDF at init (nerf_helpers.py:306)
            getattr(self, f"sigma_{num_layers - 1}").bias.fill_(0.1)

    def _sigma(self, pos_embed):
        h = pos_embed
        for l in range(self.num_layers):
            h = getattr(self, f"sigma_{l}")(h)
            if l != self.num_layers - 1:
                h = torch.relu(h)
        return h

    def forward(self, pos_embed, view_embed):
        """pos_embed: (..., C_pos); view_embed: (..., C_view) = [frame feats |
        SH dirs]. Returns (..., 4): rgb logits + sdf."""
        h = self._sigma(pos_embed)
        sdf, geo_feat = h[..., 0], h[..., 1:]
        c = torch.cat([view_embed, geo_feat], dim=-1)
        for l in range(self.num_layers_color):
            c = getattr(self, f"color_{l}")(c)
            if l != self.num_layers_color - 1:
                c = torch.relu(c)
        return torch.cat([c, sdf[..., None]], dim=-1)

    def sdf_only(self, pos_embed):
        return self._sigma(pos_embed)[..., 0]


class ObjectField(nn.Module):
    """Positional encoder + NeRFSmall + per-frame pose / feature arrays.

    ``encoder="hash"`` is the instant-ngp hash grid (the reference's own
    encoder); ``encoder="triplane"`` the multiresolution triplane with a
    frequency-encoding tail for sub-plane detail. Parameters are drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` (the JAX package's
    distributions, not its draws).
    """

    def __init__(self, num_frames, frame_features=2, sh_degree=3, max_trans=0.02,
                 max_rot_deg=10.0, num_levels=16, level_dim=2, base_resolution=32,
                 desired_resolution=512, log2_hashmap_size=22, optimize_poses=True,
                 encoder="hash", triplane_resolutions=(16, 32, 64, 128), triplane_channels=4,
                 triplane_freqs=4, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.num_frames, self.frame_features = num_frames, frame_features
        self.sh_degree, self.max_trans, self.max_rot_deg = sh_degree, max_trans, max_rot_deg
        self.optimize_poses, self.encoder = optimize_poses, encoder
        self.triplane_freqs = triplane_freqs
        if encoder == "triplane":
            self.grid = TriplaneEncoder(triplane_resolutions, triplane_channels, generator=gen)
            pos_dim = triplane_out_dim(triplane_resolutions, triplane_channels)
            if triplane_freqs > 0:
                pos_dim += freq_out_dim(triplane_freqs)
        else:
            self.grid = HashGridEncoder(num_levels, level_dim, base_resolution,
                                        desired_resolution, log2_hashmap_size, generator=gen)
            pos_dim = self.grid.out_dim
        self.mlp = NeRFSmall(pos_dim, frame_features + sh_out_dim(sh_degree), seed=seed)
        if frame_features > 0:
            self.feature_array = nn.Parameter(
                torch.randn((num_frames, frame_features), generator=gen))
        if optimize_poses:
            self.pose_array = nn.Parameter(torch.zeros((num_frames, 6)))

    def pose_corrections(self, frame_ids):
        """(N,) frame ids -> (N,4,4) bounded SE3 delta; frame 0 = identity
        (nerf_helpers.py:54-64)."""
        dev = frame_ids.device
        if not self.optimize_poses:
            return torch.eye(4, device=dev).expand(frame_ids.shape[0], 4, 4)
        theta = torch.tanh(self.pose_array)
        trans = theta[:, :3] * self.max_trans
        rot = theta[:, 3:] * (self.max_rot_deg / 180.0 * math.pi)
        Ts = geo.se3_exp_map(torch.cat([trans, rot], dim=-1))  # (F,4,4)
        Ts = torch.cat([torch.eye(4, device=dev)[None], Ts[1:]])
        return Ts[frame_ids]

    def _pos_embed(self, flat):
        emb = self.grid(clip(flat, -1.0, 1.0))
        if self.encoder == "triplane" and self.triplane_freqs > 0:
            emb = torch.cat([emb, freq_encode(flat, self.triplane_freqs)], dim=-1)
        return emb

    def query(self, pts_w, viewdirs_w, frame_ids):
        """pts_w: (N,S,3) world(normalized) points; viewdirs_w: (N,3) unit;
        frame_ids: (N,) int. Returns raw (N,S,4) [rgb logits, sdf]."""
        N, S = pts_w.shape[:2]
        pos_embed = self._pos_embed(pts_w.reshape(-1, 3))
        view = sh_encode(viewdirs_w, self.sh_degree)  # (N, sh)
        view = view[:, None].expand(N, S, view.shape[-1]).reshape(N * S, -1)
        if self.frame_features > 0:
            feats = self.feature_array[frame_ids]  # (N,D)
            feats = feats[:, None].expand(N, S, feats.shape[-1]).reshape(N * S, -1)
            view_embed = torch.cat([feats, view], dim=-1)
        else:
            view_embed = view
        return self.mlp(pos_embed, view_embed).reshape(N, S, 4)

    def sdf(self, pts):
        """(N,3) normalized points -> (N,) SDF (mesh extraction path,
        reference run_network_density nerf_runner.py:1020-1060)."""
        return self.mlp.sdf_only(self._pos_embed(pts))

    def forward(self, pts_w, viewdirs_w, frame_ids):
        return self.query(pts_w, viewdirs_w, frame_ids)
