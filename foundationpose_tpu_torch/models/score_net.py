"""ScoreNetMultiPair — hypothesis scorer with cross-pose attention.

Counterpart of foundationpose_tpu/models/score_net.py::ScoreNetMultiPair:
per-pair CNN encoding of (rendered, observed) crops, token self-attention +
mean pooling into a 512-d pair feature, then attention ACROSS the L pose
hypotheses of one frame and a linear score head. ``residual_attn=True``
wraps both attentions with ``x + att(x)`` (what the shipped checkpoint was
trained with); False is the reference forward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from foundationpose_tpu_torch.models.layers import (
    Linear,
    MultiheadSelfAttention,
    PositionalEmbedding,
)
from foundationpose_tpu_torch.models.refine_net import EncoderA, EncoderAB, encode_pair


class ScoreNetMultiPair(nn.Module):
    def __init__(self, c_in=6, norm: Optional[str] = None, dtype=torch.float32,
                 pos_grid_mode="regrid", residual_attn=False):
        super().__init__()
        self.dtype, self.pos_grid_mode = dtype, pos_grid_mode
        self.residual_attn = residual_attn
        self.encoderA = EncoderA(c_in, norm)
        self.encoderAB = EncoderAB(norm)
        self.pos_embed = PositionalEmbedding(512, max_len=400)
        self.att = MultiheadSelfAttention(512, 4)
        self.att_cross = MultiheadSelfAttention(512, 4)
        self.linear = Linear(512, 1)

    def forward(self, A, B, L):
        """A/B: (B*L,H,W,c_in); L: hypotheses per frame.
        Returns {'score_logit': (B, L)} float32."""
        return self.rank(self.pair_features(A, B), L)

    def pair_features(self, A, B):
        """The per-pair half: each (rendered, observed) crop pair on its own
        -> (N, 512) pooled feature. Nothing crosses the batch axis, so a
        sharded scorer encodes its slice and gathers the features."""
        tokens, grid_hw = encode_pair(self.encoderA, self.encoderAB, A, B, self.dtype)
        tokens = self.pos_embed(
            tokens,
            grid_hw=grid_hw if self.pos_grid_mode == "regrid" else None,
            train_hw=(20, 20),
        )
        att = self.att(tokens)
        tokens = tokens + att if self.residual_attn else att
        return tokens.mean(dim=1)

    def rank(self, feats, L):
        """The cross-pose half: (B*L, 512) pair features -> {'score_logit':
        (B, L)} float32, attention across the L hypotheses of each frame."""
        feats = feats.reshape(feats.shape[0] // L, L, -1)  # (B,L,512)
        cross = self.att_cross(feats)
        feats = feats + cross if self.residual_attn else cross
        return {"score_logit": self.linear(feats)[..., 0].float()}
