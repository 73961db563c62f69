"""Segment Anything (Kirillov et al., arXiv:2304.02643), the port's box
segmenter: the ViT image encoder with windowed and global attention and
decomposed relative positions, the neck, the prompt encoder and the two-way
mask decoder.

Modules and parameter names follow ``segment_anything`` (``build_sam.py``,
``modeling/``), so a ``sam_vit_h_4b8939.pth`` state dict loads as it is;
``from_hf_state_dict`` renames a HuggingFace ``SamModel`` state dict to the
same names. ``SamConfig`` holds ``build_sam``'s arguments; its defaults are
the published ``vit_h`` widths.

Precision: every parameter but the norms' and the prompt encoder's Gaussian
matrix is held in the compute dtype (bfloat16 on the card); norms and the
random-Fourier encoding compute in float32, as ``models/layers.py`` does.
Attention runs through ``scaled_dot_product_attention`` with the decomposed
relative-position bias as its additive float mask; the bias is never dropped.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationpose_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from foundationpose_tpu_torch.utils.profiling import span

ENCODER_NORM_EPS = 1e-6  # the image encoder's LayerNorms and every LayerNorm2d
DECODER_NORM_EPS = 1e-5  # nn.LayerNorm's default, in the two-way transformer


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """``build_sam``'s arguments plus the compute dtype."""
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: tuple = (7, 15, 23, 31)
    image_size: int = 1024
    vit_patch_size: int = 16
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    mask_in_chans: int = 16
    pixel_mean: tuple = (123.675, 116.28, 103.53)
    pixel_std: tuple = (58.395, 57.12, 57.375)
    dtype: str = "bfloat16"

    @property
    def grid(self):
        """Side of the image embedding's token grid (64 at 1024 px)."""
        return self.image_size // self.vit_patch_size

    @classmethod
    def from_dict(cls, d):
        """From a dict of these fields (others ignored, lists as tuples)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})


class LayerNorm2d(nn.Module):
    """``segment_anything``'s channels-first LayerNorm, in float32."""

    def __init__(self, channels, eps=ENCODER_NORM_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        y = x.float()
        u = y.mean(1, keepdim=True)
        s = (y - u).pow(2).mean(1, keepdim=True)
        y = (y - u) / torch.sqrt(s + self.eps)
        return (self.weight[:, None, None] * y + self.bias[:, None, None]).to(x.dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride)


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden, act):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------- encoder

def rel_pos_table(size, rel_pos):
    """(size, size, head_dim): the relative-position row of each (query,
    key) coordinate pair along one axis (``segment_anything``'s
    ``get_rel_pos`` for equal query and key sizes, whose table has
    2 * size - 1 rows, so nothing is resampled)."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"relative positions of {rel_pos.shape[0]} rows for an axis of {size}")
    i = torch.arange(size, device=rel_pos.device)
    return rel_pos[i[:, None] - i[None, :] + (size - 1)]


def rel_pos_bias(q, table_h, table_w):
    """The decomposed relative-position bias (B, heads, H*W, H*W) of queries
    q (B, heads, H*W, d), taken on the unscaled q, from the (H, H, d) and
    (W, W, d) tables of ``rel_pos_table``:
    bias[(qh, qw), (kh, kw)] = q . R_h[qh, kh] + q . R_w[qw, kw]."""
    B, nh, n, d = q.shape
    H, W = table_h.shape[0], table_w.shape[0]
    r_q = q.reshape(B * nh, H, W, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, table_h)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, table_w)
    return (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(B, nh, n, n)


class Attention(nn.Module):
    """Multi-head attention over an (H, W) token grid with decomposed
    relative positions; ``input_size`` is the grid (the window, or the whole
    64 x 64 grid in a global block)."""

    def __init__(self, dim, num_heads, input_size, is_global):
        super().__init__()
        self.num_heads = num_heads
        self.is_global = is_global
        head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))
        self._tables = None  # (key, table_h, table_w)

    def rel_pos_tables(self, hw, dtype):
        """The gathered relative-position tables in ``dtype``. They depend on
        the weights alone, so without autograd they are gathered once and
        kept until a parameter is written, moved or cast: eight launches and
        their host time less a block and a call."""
        ph, pw = self.rel_pos_h, self.rel_pos_w
        key = (hw, dtype, ph.data_ptr(), ph._version, pw.data_ptr(), pw._version)
        if self._tables is not None and self._tables[0] == key:
            return self._tables[1:]
        tables = (rel_pos_table(hw[0], ph).to(dtype), rel_pos_table(hw[1], pw).to(dtype))
        self._tables = None if torch.is_grad_enabled() else (key, *tables)
        return tables

    def forward(self, x):
        B, H, W, _ = x.shape
        n, nh = H * W, self.num_heads
        q, k, v = self.qkv(x).reshape(B, n, 3, nh, -1).permute(2, 0, 3, 1, 4).unbind(0)
        with (span("sam.attn.global", B * nh, n) if self.is_global
              else span("sam.attn.window", B * nh, n)):
            bias = rel_pos_bias(q, *self.rel_pos_tables((H, W), q.dtype))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(o.transpose(1, 2).reshape(B, H, W, -1))


def window_partition(x, window):
    """(B, H, W, C) -> (B * windows, window, window, C), the grid padded with
    zeros at its bottom and right to a multiple of ``window``; and the padded
    (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % window, (-W) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(windows, window, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.view(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous() if (Hp > H or Wp > W) else x


class Block(nn.Module):
    """Pre-norm transformer block; attention inside ``window_size`` windows,
    or over the whole grid where ``window_size`` is 0."""

    def __init__(self, dim, num_heads, mlp_ratio, window_size, grid):
        super().__init__()
        self.window_size = window_size
        size = (window_size, window_size) if window_size else (grid, grid)
        self.norm1 = LayerNorm(dim, eps=ENCODER_NORM_EPS)
        self.attn = Attention(dim, num_heads, size, is_global=not window_size)
        self.norm2 = LayerNorm(dim, eps=ENCODER_NORM_EPS)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), F.gelu)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(x), self.window_size, pad_hw, (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        dim, g = cfg.encoder_embed_dim, cfg.grid
        self.patch_embed = PatchEmbed(cfg.vit_patch_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        self.blocks = nn.ModuleList(
            Block(dim, cfg.encoder_num_heads, cfg.mlp_ratio,
                  0 if i in cfg.encoder_global_attn_indexes else cfg.window_size, g)
            for i in range(cfg.encoder_depth))
        self.neck = nn.Sequential(
            Conv2d(dim, cfg.prompt_embed_dim, 1, bias=False),
            LayerNorm2d(cfg.prompt_embed_dim),
            Conv2d(cfg.prompt_embed_dim, cfg.prompt_embed_dim, 3, padding=1, bias=False),
            LayerNorm2d(cfg.prompt_embed_dim))

    def forward(self, x):
        """(B, 3, S, S) normalised and padded -> (B, 256, S/16, S/16)."""
        with span("sam.encoder", x.shape[0], (x.shape[2] // self.patch_embed.proj.stride[0]) ** 2):
            x = self.patch_embed(x) + self.pos_embed.to(x.dtype)
            for blk in self.blocks:
                x = blk(x)
        with span("sam.neck"):
            return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------- prompt

class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positions: sin and cos of 2 pi (2 xy - 1) @ G, float32."""

    def __init__(self, num_pos_feats):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def _encode(self, coords):
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size):
        """(C, size, size) at the token centres."""
        g = torch.ones((size, size), device=self.positional_encoding_gaussian_matrix.device)
        y = (g.cumsum(dim=0) - 0.5) / size
        x = (g.cumsum(dim=1) - 0.5) / size
        return self._encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)

    def coords(self, xy, image_size):
        """(..., 2) pixel coordinates of the padded input -> (..., C)."""
        return self._encode(xy.float() / image_size)


class PromptEncoder(nn.Module):
    """Box prompts only (the points' and the mask input's modules are kept
    for the checkpoint's names)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        d, c = cfg.prompt_embed_dim, cfg.mask_in_chans
        self.image_size, self.grid_size = cfg.image_size, cfg.grid
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, stride=2), LayerNorm2d(c // 4), nn.GELU(),
            nn.Conv2d(c // 4, c, 2, stride=2), LayerNorm2d(c), nn.GELU(),
            nn.Conv2d(c, d, 1))
        self.no_mask_embed = nn.Embedding(1, d)

    def forward(self, boxes, dtype):
        """boxes (B, 4) x0, y0, x1, y1 in the padded input's pixels -> sparse
        (B, 2, C) corner embeddings, dense (B, C, g, g), and the image's
        positional encoding (1, C, g, g), all in ``dtype``."""
        corners = self.pe_layer.coords((boxes + 0.5).reshape(-1, 2, 2), self.image_size)
        corners = corners + torch.cat([self.point_embeddings[2].weight,
                                       self.point_embeddings[3].weight]).float()[None]
        g = self.grid_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(len(boxes), -1, g, g)
        pe = self.pe_layer.grid(g)[None]
        return corners.to(dtype), dense.to(dtype), pe.to(dtype)


# ---------------------------------------------------------------- decoder

class DecoderAttention(nn.Module):
    """Attention whose inner width is ``dim / downsample_rate``."""

    def __init__(self, dim, num_heads, downsample_rate=1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(dim, inner)
        self.k_proj = Linear(dim, inner)
        self.v_proj = Linear(dim, inner)
        self.out_proj = Linear(inner, dim)

    def forward(self, q, k, v):
        def heads(x):
            B, N, C = x.shape
            return x.reshape(B, N, self.num_heads, C // self.num_heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(self.q_proj(q)), heads(self.k_proj(k)),
                                           heads(self.v_proj(v)))
        B, _, N, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(B, N, -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, downsample_rate, skip_first_layer_pe):
        super().__init__()
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim, eps=DECODER_NORM_EPS)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, downsample_rate)
        self.norm2 = LayerNorm(dim, eps=DECODER_NORM_EPS)
        self.mlp = MLPBlock(dim, mlp_dim, F.relu)
        self.norm3 = LayerNorm(dim, eps=DECODER_NORM_EPS)
        self.norm4 = LayerNorm(dim, eps=DECODER_NORM_EPS)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(d, cfg.decoder_num_heads, cfg.decoder_mlp_dim,
                                 cfg.attention_downsample_rate, i == 0)
            for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(d, cfg.decoder_num_heads,
                                                          cfg.attention_downsample_rate)
        self.norm_final_attn = LayerNorm(d, eps=DECODER_NORM_EPS)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        return self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys)), keys


class MLP(nn.Module):
    def __init__(self, dim_in, hidden, dim_out, num_layers):
        super().__init__()
        dims = [dim_in] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims, dims[1:] + [dim_out]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.num_multimask_outputs = cfg.num_multimask_outputs
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4), nn.GELU(),
            ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, cfg.iou_head_hidden_dim, self.num_mask_tokens,
                                       cfg.iou_head_depth)

    def forward(self, image, image_pe, sparse, dense):
        """-> the multimask outputs: low-res mask logits (B, 3, 4g, 4g) and
        predicted IoUs (B, 3)."""
        B = sparse.shape[0]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight]).to(sparse.dtype)
        tokens = torch.cat([out[None].expand(B, -1, -1), sparse], dim=1)
        src = image.repeat_interleave(B, dim=0) + dense
        pos = image_pe.repeat_interleave(B, dim=0)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos, tokens)
        up = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        iou = self.iou_prediction_head(hs[:, 0])
        return masks[:, 1:], iou[:, 1:]


# ---------------------------------------------------------------- the model

class Sam(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    @property
    def dtype(self):
        return self.image_encoder.pos_embed.dtype

    def to_compute_dtype(self, dtype):
        """Hold every parameter but the norms' in ``dtype``."""
        norms = {id(p) for m in self.modules() if isinstance(m, (nn.LayerNorm, LayerNorm2d))
                 for p in m.parameters()}
        for p in self.parameters():
            if id(p) not in norms:
                p.data = p.data.to(dtype)
        return self

    def encode(self, x):
        """(B, 3, S, S) normalised and padded, float32 -> image embedding."""
        return self.image_encoder(x.to(self.dtype))

    def decode(self, embedding, boxes):
        """Box prompts (B, 4) in the padded input's pixels -> (low-res logits
        (B, 3, 4g, 4g), predicted IoUs (B, 3)), both float32."""
        with span("sam.prompt"):
            sparse, dense, pe = self.prompt_encoder(boxes, embedding.dtype)
        with span("sam.decoder"):
            masks, iou = self.mask_decoder(embedding, pe, sparse, dense)
        return masks.float(), iou.float()


def build_sam(cfg: SamConfig, device, checkpoint):
    """The net on ``device`` in ``cfg.dtype`` with the state dict of
    ``checkpoint`` (a ``segment_anything`` or HuggingFace state dict, or a
    path to one), every tensor of it named and shaped as ``cfg`` says."""
    with torch.device(device):
        net = Sam(cfg)
    sd = load_state_dict(checkpoint) if isinstance(checkpoint, str) else checkpoint
    net.load_state_dict(from_hf_state_dict(sd), strict=True)
    return net.to_compute_dtype(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32).eval()


def load_state_dict(path):
    """A state dict from a ``.pth`` file, or from a HuggingFace checkpoint
    directory (``model.safetensors`` or ``pytorch_model.bin``)."""
    import os

    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            from safetensors.torch import load_file

            return load_file(st)
        path = os.path.join(path, "pytorch_model.bin")
    return torch.load(path, map_location="cpu", weights_only=True)


def config_from_state_dict(sd, **over):
    """The ``SamConfig`` a ``segment_anything`` state dict was built with:
    widths from the tensors' shapes, global blocks from their relative
    position tables."""
    sd = from_hf_state_dict(sd)
    dim, patch = sd["image_encoder.patch_embed.proj.weight"].shape[0::2]
    grid = sd["image_encoder.pos_embed"].shape[1]
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("image_encoder.blocks."))
    rel = [sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"] for i in range(depth)]
    window = min(r.shape[0] for r in rel) // 2 + 1
    d = sd["mask_decoder.iou_token.weight"].shape[1]
    n_dec = 1 + max(int(k.split(".")[3]) for k in sd
                    if k.startswith("mask_decoder.transformer.layers."))
    head_inner = sd["mask_decoder.transformer.layers.0.cross_attn_token_to_image.q_proj.weight"]
    cfg = dict(
        encoder_embed_dim=dim, encoder_depth=depth, encoder_num_heads=dim // rel[0].shape[1],
        encoder_global_attn_indexes=tuple(i for i, r in enumerate(rel) if r.shape[0] == 2 * grid - 1),
        image_size=grid * patch, vit_patch_size=patch,
        window_size=window if window != grid else 0,
        mlp_ratio=sd["image_encoder.blocks.0.mlp.lin1.weight"].shape[0] / dim,
        prompt_embed_dim=d, decoder_depth=n_dec,
        decoder_mlp_dim=sd["mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0],
        attention_downsample_rate=d // head_inner.shape[0],
        num_multimask_outputs=sd["mask_decoder.mask_tokens.weight"].shape[0] - 1,
        iou_head_hidden_dim=sd["mask_decoder.iou_prediction_head.layers.0.weight"].shape[0],
        mask_in_chans=sd["prompt_encoder.mask_downscaling.3.weight"].shape[0])
    cfg.update(over)
    return SamConfig(**cfg)


_HF_RENAMES = [
    (r"^shared_image_embedding\.positional_embedding$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^vision_encoder\.patch_embed\.projection\.", "image_encoder.patch_embed.proj."),
    (r"^vision_encoder\.layers\.(\d+)\.layer_norm(\d)\.", r"image_encoder.blocks.\1.norm\2."),
    (r"^vision_encoder\.layers\.", "image_encoder.blocks."),
    (r"^vision_encoder\.neck\.conv1\.", "image_encoder.neck.0."),
    (r"^vision_encoder\.neck\.layer_norm1\.", "image_encoder.neck.1."),
    (r"^vision_encoder\.neck\.conv2\.", "image_encoder.neck.2."),
    (r"^vision_encoder\.neck\.layer_norm2\.", "image_encoder.neck.3."),
    (r"^vision_encoder\.", "image_encoder."),
    (r"^prompt_encoder\.mask_embed\.conv1\.", "prompt_encoder.mask_downscaling.0."),
    (r"^prompt_encoder\.mask_embed\.layer_norm1\.", "prompt_encoder.mask_downscaling.1."),
    (r"^prompt_encoder\.mask_embed\.conv2\.", "prompt_encoder.mask_downscaling.3."),
    (r"^prompt_encoder\.mask_embed\.layer_norm2\.", "prompt_encoder.mask_downscaling.4."),
    (r"^prompt_encoder\.mask_embed\.conv3\.", "prompt_encoder.mask_downscaling.6."),
    (r"^prompt_encoder\.point_embed\.", "prompt_encoder.point_embeddings."),
    (r"\.layer_norm_final_attn\.", ".norm_final_attn."),
    (r"^(mask_decoder\.transformer\.layers\.\d+)\.layer_norm(\d)\.", r"\1.norm\2."),
    (r"^mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_layer_norm\.", "mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
]


def from_hf_state_dict(sd):
    """A HuggingFace ``SamModel`` state dict under ``segment_anything``'s
    names (a ``segment_anything`` state dict comes back as it is)."""
    if not any(k.startswith("vision_encoder.") for k in sd):
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if k.startswith("prompt_encoder.shared_embedding."):
            continue  # tied to shared_image_embedding
        for pat, rep in _HF_RENAMES:
            k = re.sub(pat, rep, k)
        m = re.match(r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|iou_prediction_head))\."
                     r"(proj_in|layers\.(\d+)|proj_out)\.(.*)$", k)
        if m:  # proj_in, layers.0 ..., proj_out -> layers.0, 1, ...
            n_hidden = sum(1 for j in sd if j.startswith(m.group(1) + ".layers.")
                           and j.endswith(".weight"))
            idx = {"proj_in": 0, "proj_out": n_hidden + 1}.get(m.group(2))
            idx = int(m.group(3)) + 1 if idx is None else idx
            k = f"{m.group(1)}.layers.{idx}.{m.group(4)}"
        out[k] = v
    return out
