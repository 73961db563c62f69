"""RefineNet and ScoreNet (FoundationPose, Wen et al. CVPR 2024), plain.

Widths as published: a shared encoder over the rendered (A) and observed (B)
6-channel crops (7x7/2 conv to 64, 3x3/2 to 128, two residual blocks), the
pair concatenated to 256 channels, two residual blocks, 3x3/2 to 512, two
more; the 20x20 map is 400 tokens of 512 with sinusoidal positions. RefineNet
has two post-LayerNorm transformer layers (4 heads, feed-forward 512) with
linear heads for translation (3) and axis-angle rotation (3), averaged over
tokens. ScoreNet has token self-attention, a mean over tokens, attention
across the hypotheses of a frame and a linear score; the shipped weights use
GroupNorm(16) in its convolutions and residual attention.

Everything computes in float32. ``set_quant(net, "fp8")`` makes every
convolution and linear layer read its input and weight rounded to float8
e4m3 with one scale per tensor: the control one precision below the
program's bfloat16.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


def _fp8(x):
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        w = self.weight
        if self.quant == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class Dense(nn.Linear):
    quant = None

    def forward(self, x):
        w = self.weight
        if self.quant == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, self.bias)


def set_quant(net, quant):
    for m in net.modules():
        if isinstance(m, (Conv, Dense)):
            m.quant = quant
    return net


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, k, stride, norm):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride=stride, padding=(k - 1) // 2)
        if norm:
            self.GroupNorm_0 = nn.GroupNorm(16, cout, eps=EPS)
        self.norm = norm

    def forward(self, x):
        x = self.conv(x)
        if self.norm:
            x = self.GroupNorm_0(x)
        return F.relu(x)


class ResBlock(nn.Module):
    def __init__(self, c, norm):
        super().__init__()
        self.conv1 = Conv(c, c, 3, padding=1)
        self.conv2 = Conv(c, c, 3, padding=1)
        if norm:
            self.GroupNorm_0 = nn.GroupNorm(16, c, eps=EPS)
            self.GroupNorm_1 = nn.GroupNorm(16, c, eps=EPS)
        self.norm = norm

    def forward(self, x):
        y = self.conv1(x)
        if self.norm:
            y = self.GroupNorm_0(y)
        y = self.conv2(F.relu(y))
        if self.norm:
            y = self.GroupNorm_1(y)
        return F.relu(y + x)


class EncoderA(nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.conv0 = ConvNormAct(6, 64, 7, 2, norm)
        self.conv1 = ConvNormAct(64, 128, 3, 2, norm)
        self.res0 = ResBlock(128, norm)
        self.res1 = ResBlock(128, norm)

    def forward(self, x):
        return self.res1(self.res0(self.conv1(self.conv0(x))))


class EncoderAB(nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.res0 = ResBlock(256, norm)
        self.res1 = ResBlock(256, norm)
        self.conv0 = ConvNormAct(256, 512, 3, 2, norm)
        self.res2 = ResBlock(512, norm)
        self.res3 = ResBlock(512, norm)

    def forward(self, x):
        return self.res3(self.res2(self.conv0(self.res1(self.res0(x)))))


def positions(n_tokens, hw, d=512, train_hw=(20, 20)):
    """Sinusoidal table over the 20x20 training grid, resampled bilinearly
    (align-corners) when the token grid is another."""
    L = train_hw[0] * train_hw[1]
    pe = np.zeros((L, d), np.float32)
    pos = np.arange(L, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    if tuple(hw) == tuple(train_hw):
        return torch.from_numpy(pe[:n_tokens])
    H, W = train_hw
    h, w = hw
    g = pe.reshape(H, W, -1)
    rf, cf = np.linspace(0.0, H - 1.0, h), np.linspace(0.0, W - 1.0, w)
    r0 = np.clip(np.floor(rf).astype(int), 0, H - 2)
    c0 = np.clip(np.floor(cf).astype(int), 0, W - 2)
    ar, ac = (rf - r0)[:, None, None], (cf - c0)[None, :, None]
    top = g[r0][:, c0] * (1 - ac) + g[r0][:, c0 + 1] * ac
    bot = g[r0 + 1][:, c0] * (1 - ac) + g[r0 + 1][:, c0 + 1] * ac
    return torch.from_numpy((top * (1 - ar) + bot * ar).reshape(h * w, -1).astype(np.float32))


class SelfAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(d, 3 * d)
        self.out_proj = Dense(d, d)

    def forward(self, x):
        B, N, D = x.shape
        dh = D // self.heads
        q, k, v = (t.reshape(B, N, self.heads, dh).transpose(1, 2)
                   for t in self.in_proj(x).split(D, dim=-1))
        a = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        return self.out_proj((a @ v).transpose(1, 2).reshape(B, N, D))


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, ff):
        super().__init__()
        self.self_attn = SelfAttention(d, heads)
        self.norm1 = nn.LayerNorm(d, eps=EPS)
        self.linear1 = Dense(d, ff)
        self.linear2 = Dense(ff, d)
        self.norm2 = nn.LayerNorm(d, eps=EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def _tokens(encA, encAB, A, B):
    n = A.shape[0]
    x = encA(torch.cat([A, B]).permute(0, 3, 1, 2))
    ab = encAB(torch.cat([x[:n], x[n:]], dim=1))
    hw = (ab.shape[2], ab.shape[3])
    tok = ab.flatten(2).transpose(1, 2)
    return tok + positions(tok.shape[1], hw).to(tok.device)[None]


class RefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encodeA = EncoderA(None)
        self.encodeAB = EncoderAB(None)
        self.trans_tf = EncoderLayer(512, 4, 512)
        self.trans_out = Dense(512, 3)
        self.rot_tf = EncoderLayer(512, 4, 512)
        self.rot_out = Dense(512, 3)

    def forward(self, A, B):
        tok = _tokens(self.encodeA, self.encodeAB, A, B)
        return (self.trans_out(self.trans_tf(tok)).mean(dim=1),
                self.rot_out(self.rot_tf(tok)).mean(dim=1))


class ScoreNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoderA = EncoderA("group")
        self.encoderAB = EncoderAB("group")
        self.att = SelfAttention(512, 4)
        self.att_cross = SelfAttention(512, 4)
        self.linear = Dense(512, 1)

    def forward(self, A, B):
        """All hypotheses of one frame -> (N,) logits."""
        tok = _tokens(self.encoderA, self.encoderAB, A, B)
        feats = (tok + self.att(tok)).mean(dim=1)[None]
        feats = feats + self.att_cross(feats)
        return self.linear(feats)[0, :, 0]


def load_npz(net, path):
    """Weights saved as flat ``params/<module path>/kernel|bias|scale``
    arrays (convolutions HWIO, dense kernels (in, out)), into ``net``."""
    want = net.state_dict()
    got = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")[1:]
            name = ".".join(parts[:-1] + ["bias" if parts[-1] == "bias" else "weight"])
            a = np.asarray(data[key], np.float32)
            if parts[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            got[name] = torch.from_numpy(np.ascontiguousarray(a))
    missing, extra = set(want) - set(got), set(got) - set(want)
    if missing or extra:
        raise KeyError(f"weights do not fit the net: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    net.load_state_dict(got)
    return net
