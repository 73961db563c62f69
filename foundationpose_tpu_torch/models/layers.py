"""Shared network building blocks (torch ``nn.Module``s).

Counterpart of foundationpose_tpu/models/layers.py: ``ConvNormAct``,
``ResnetBasicBlock``, GroupNorm(16), ``sinusoidal_positions``,
``regrid_positions``, ``PositionalEmbedding``, ``MultiheadSelfAttention``,
``TransformerEncoderLayer`` (post-LayerNorm, ReLU feed-forward).

Sub-module names follow the flax parameter tree (``conv``, ``GroupNorm_0``,
``in_proj`` ...) so ``models/convert.py`` maps a checkpoint key by key.
Modules compute NCHW internally. Parameters stay float32 and are cast to the
input's dtype at use, so one set of weights serves float32 (CPU tests) and
bfloat16 (the card); norm statistics and the attention softmax are float32
either way. Norm eps is 1e-6 (the flax default; torch's is 1e-5).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-6


class Conv2d(nn.Conv2d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def _make_norm(norm: Optional[str], channels: int):
    if norm is None or norm == "none":
        return None
    if norm == "group":
        return GroupNorm(16, channels, eps=NORM_EPS)
    # inference-style batch norm is folded into the convs at import time in
    # the JAX package; the port has no checkpoint that needs it yet
    raise ValueError(f"unknown norm {norm}")


class ConvNormAct(nn.Module):
    """Conv + optional norm + optional ReLU, symmetric (k-1)//2 padding."""

    def __init__(self, c_in, features, kernel_size=3, stride=1, norm=None, act=True):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv = Conv2d(c_in, features, kernel_size, stride=stride, padding=p)
        n = _make_norm(norm, features)
        if n is not None:
            self.GroupNorm_0 = n
        self.has_norm = n is not None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.has_norm:
            x = self.GroupNorm_0(x)
        return F.relu(x) if self.act else x


class ResnetBasicBlock(nn.Module):
    """Two 3x3 convs with residual (stride 1, no downsample)."""

    def __init__(self, planes, norm=None):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 3, padding=1)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.has_norm = _make_norm(norm, planes) is not None
        if self.has_norm:
            self.GroupNorm_0 = _make_norm(norm, planes)
            self.GroupNorm_1 = _make_norm(norm, planes)

    def forward(self, x):
        y = self.conv1(x)
        if self.has_norm:
            y = self.GroupNorm_0(y)
        y = F.relu(y)
        y = self.conv2(y)
        if self.has_norm:
            y = self.GroupNorm_1(y)
        return F.relu(y + x)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) sin/cos table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def regrid_positions(pe: np.ndarray, train_hw, out_hw) -> np.ndarray:
    """Bilinearly resample a (H*W, D) positional table laid out row-major
    over ``train_hw`` onto an ``out_hw`` token grid (align-corners), so a net
    run on smaller crops reads in-distribution positions."""
    H, W = train_hw
    h, w = out_hw
    pe2 = pe.reshape(H, W, -1)
    rf = np.linspace(0.0, H - 1.0, h)
    cf = np.linspace(0.0, W - 1.0, w)
    r0 = np.clip(np.floor(rf).astype(int), 0, H - 2)
    c0 = np.clip(np.floor(cf).astype(int), 0, W - 2)
    ar = (rf - r0)[:, None, None]
    ac = (cf - c0)[None, :, None]
    top = pe2[r0][:, c0] * (1 - ac) + pe2[r0][:, c0 + 1] * ac
    bot = pe2[r0 + 1][:, c0] * (1 - ac) + pe2[r0 + 1][:, c0 + 1] * ac
    out = top * (1 - ar) + bot * ar
    return out.reshape(h * w, -1).astype(pe.dtype)


class PositionalEmbedding(nn.Module):
    """Adds the sinusoidal table (a buffer, never a parameter). When the
    token grid differs from ``train_hw`` and ``grid_hw`` is given, the table
    is regridded; otherwise its first ``n_tokens`` rows are used."""

    def __init__(self, d_model, max_len=512):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False,
        )
        self._regrid_cache = {}

    def forward(self, x, grid_hw=None, train_hw=None):
        if grid_hw is not None and train_hw is not None and tuple(grid_hw) != tuple(train_hw):
            key = (tuple(train_hw), tuple(grid_hw), x.device)
            if key not in self._regrid_cache:
                tab = regrid_positions(
                    sinusoidal_positions(self.max_len, self.d_model), train_hw, grid_hw)
                self._regrid_cache[key] = torch.from_numpy(tab).to(x.device)
            return x + self._regrid_cache[key].to(x.dtype)[None]
        return x + self.pe[: x.shape[1]].to(x.dtype)[None]


class MultiheadSelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` semantics for self-attention, written
    out: fused in-proj, heads, scaled dot product with a float32 softmax,
    out-proj."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Linear(embed_dim, 3 * embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, x):
        B, N, D = x.shape
        h = self.num_heads
        dh = D // h
        q, k, v = self.in_proj(x).split(D, dim=-1)

        def heads(t):
            return t.reshape(B, N, h, dh).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = LN1(x + MHA(x)); x = LN2(x + FF(x))."""

    def __init__(self, d_model, num_heads, dim_feedforward):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, num_heads)
        self.norm1 = LayerNorm(d_model, eps=NORM_EPS)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model, eps=NORM_EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        y = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + y)
