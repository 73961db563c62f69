"""RefineNet — render-and-compare pose-delta regressor.

Counterpart of foundationpose_tpu/models/refine_net.py (``EncoderA``,
``EncoderAB``, ``RefineNet``): shared CNN encoder over the rendered (A) and
observed (B) 6-channel [rgb, xyz] crops, channel-concat, deeper encoder,
20x20 -> 400-token sequence with sinusoidal positions, and two single-layer
transformer heads regressing translation (3) and rotation (axis-angle 3 or
6d). Inputs are NHWC like the JAX net; the module transposes to NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from foundationpose_tpu_torch.models.layers import (
    ConvNormAct,
    Linear,
    PositionalEmbedding,
    ResnetBasicBlock,
    TransformerEncoderLayer,
)


class EncoderA(nn.Module):
    def __init__(self, c_in, norm):
        super().__init__()
        self.conv0 = ConvNormAct(c_in, 64, 7, 2, norm=norm)
        self.conv1 = ConvNormAct(64, 128, 3, 2, norm=norm)
        self.res0 = ResnetBasicBlock(128, norm=norm)
        self.res1 = ResnetBasicBlock(128, norm=norm)

    def forward(self, x):
        return self.res1(self.res0(self.conv1(self.conv0(x))))


class EncoderAB(nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.res0 = ResnetBasicBlock(256, norm=norm)
        self.res1 = ResnetBasicBlock(256, norm=norm)
        self.conv0 = ConvNormAct(256, 512, 3, 2, norm=norm)
        self.res2 = ResnetBasicBlock(512, norm=norm)
        self.res3 = ResnetBasicBlock(512, norm=norm)

    def forward(self, x):
        return self.res3(self.res2(self.conv0(self.res1(self.res0(x)))))


def encode_pair(encA, encAB, A, B, dtype):
    """Shared trunk of both nets: (N,H,W,C) crops -> (N, h*w, 512) tokens
    (row-major over the h x w grid) and the grid shape."""
    bs = A.shape[0]
    x = torch.cat([A, B], dim=0).to(dtype).permute(0, 3, 1, 2)
    x = encA(x)
    ab = encAB(torch.cat([x[:bs], x[bs:]], dim=1))  # (N,512,h,w)
    grid_hw = (ab.shape[2], ab.shape[3])
    return ab.flatten(2).transpose(1, 2), grid_hw


class RefineNet(nn.Module):
    """``pos_grid_mode``: "regrid" resamples the 20x20 positional table on
    other token grids; "flat" slices its first h*w rows. Identical at 160 px."""

    def __init__(self, c_in=6, rot_rep="axis_angle", norm: Optional[str] = None,
                 dtype=torch.float32, pos_grid_mode="regrid"):
        super().__init__()
        self.rot_rep, self.dtype, self.pos_grid_mode = rot_rep, dtype, pos_grid_mode
        self.encodeA = EncoderA(c_in, norm)
        self.encodeAB = EncoderAB(norm)
        self.pos_embed = PositionalEmbedding(512, max_len=400)
        self.trans_tf = TransformerEncoderLayer(512, 4, 512)
        self.trans_out = Linear(512, 3)
        self.rot_tf = TransformerEncoderLayer(512, 4, 512)
        self.rot_out = Linear(512, 3 if rot_rep == "axis_angle" else 6)

    def forward(self, A, B):
        """A: rendered crops (N,H,W,c_in); B: observed crops (N,H,W,c_in).
        Returns {'trans': (N,3), 'rot': (N,3 or 6)} in float32."""
        tokens, grid_hw = encode_pair(self.encodeA, self.encodeAB, A, B, self.dtype)
        tokens = self.pos_embed(
            tokens,
            grid_hw=grid_hw if self.pos_grid_mode == "regrid" else None,
            train_hw=(20, 20),
        )
        trans = self.trans_out(self.trans_tf(tokens)).mean(dim=1)
        rot = self.rot_out(self.rot_tf(tokens)).mean(dim=1)
        return {"trans": trans.float(), "rot": rot.float()}
