"""RefineNet — render-and-compare pose-delta regressor.

Counterpart of foundationpose_tpu/models/refine_net.py (``EncoderA``,
``EncoderAB``, ``RefineNet``): shared CNN encoder over the rendered (A) and
observed (B) 6-channel [rgb, xyz] crops, channel-concat, deeper encoder,
20x20 -> 400-token sequence with sinusoidal positions, and two single-layer
transformer heads regressing translation (3) and rotation (axis-angle 3 or
6d). Inputs are NHWC like the JAX net; the module transposes to NCHW.

On a card at a 2-byte dtype the stem conv (``EncoderA.conv0``, 7x7 stride 2
over the 6-channel crops) reads its input padded with zero channels to a
multiple of 8 (``stem_channels``): 12-byte channel rows keep cuDNN on its
generic engine, 16-byte ones reach a tensor-core fprop kernel. The zero
channels add exact zero products, so the result is the same mathematics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationpose_tpu_torch.models.layers import (
    ConvNormAct,
    Linear,
    PositionalEmbedding,
    ResnetBasicBlock,
    TransformerEncoderLayer,
)
from foundationpose_tpu_torch.utils.profiling import span

STEM_ALIGN = 8  # channels: 16-byte rows at 2 bytes an element


def stem_channels(c_in, device, dtype):
    """The channel count the stem conv runs at: ``c_in`` rounded up to a
    multiple of ``STEM_ALIGN`` for a 2-byte ``dtype`` on a CUDA ``device``,
    else ``c_in`` (float32 gains nothing from tensor-core alignment without
    TF32, and would pay the padding's FLOPs)."""
    if torch.device(device).type == "cuda" and dtype.itemsize == 2:
        return -(-c_in // STEM_ALIGN) * STEM_ALIGN
    return c_in


def stem_input(A, B, dtype, channels=None):
    """The stem's input: the crops A then B, (N,H,W,c) each, cast to
    ``dtype`` as a (2N, channels, H, W) channels-last view whose channels
    past c are zero. ``channels`` defaults to ``stem_channels``; tests force
    it on the CPU."""
    n, c = A.shape[0], A.shape[-1]
    if channels is None:
        channels = stem_channels(c, A.device, dtype)
    if channels == c:
        x = torch.cat([A, B], dim=0).to(dtype)
    else:
        x = A.new_zeros((2 * n,) + A.shape[1:-1] + (channels,), dtype=dtype)
        x[:n, ..., :c] = A
        x[n:, ..., :c] = B
    return x.permute(0, 3, 1, 2)


class EncoderA(nn.Module):
    def __init__(self, c_in, norm):
        super().__init__()
        self.conv0 = ConvNormAct(c_in, 64, 7, 2, norm=norm)
        self.conv1 = ConvNormAct(64, 128, 3, 2, norm=norm)
        self.res0 = ResnetBasicBlock(128, norm=norm)
        self.res1 = ResnetBasicBlock(128, norm=norm)

    def forward(self, x):
        """x: (N, C, H, W) from ``stem_input``; C may exceed ``c_in`` by zero
        channels."""
        with span("net.stem", x.shape[0], x.shape[1]):
            x = self.stem(x)
        return self.res1(self.res0(self.conv1(x)))

    def stem(self, x):
        """``conv0`` on x. Where x carries zero channels past ``c_in``, the
        weight gains as many zero input channels, built from the live
        parameter at every call, so training, weight loads and graph capture
        never meet a stale copy; it is laid out channels-last, as cuDNN
        takes it."""
        c0 = self.conv0
        w = c0.conv.weight
        if x.shape[1] == w.shape[1]:
            return c0(x)
        o, c, kh, kw = w.shape
        wp = w.new_zeros((o, kh, kw, x.shape[1]), dtype=x.dtype).permute(0, 3, 1, 2)
        wp[:, :c] = w
        y = F.conv2d(x, wp, c0.conv.bias.to(x.dtype), c0.conv.stride, c0.conv.padding)
        if c0.has_norm:
            y = c0.GroupNorm_0(y)
        return F.relu(y) if c0.act else y


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
    x = encA(stem_input(A, B, dtype))
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
