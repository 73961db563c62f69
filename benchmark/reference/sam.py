"""Segment Anything (Kirillov et al., arXiv:2304.02643) on one box prompt,
plain: ``segment_anything``'s ``SamPredictor.set_image`` + ``predict(box=...,
multimask_output=True)`` written out in float32 ``torch`` operations over a
state dict under ``segment_anything``'s names. ``draw_weights`` makes that
state dict from a seed, over the tensor names and shapes written out here
from the published modules (``param_shapes``), so neither the weights nor
how strongly they let a fault show come from the engine.

Attention is written out (scores, the decomposed relative-position bias, a
softmax, the weighted sum); no fused attention, no kernel of the engine.
Precision: float32 with TF32 off, which ``reference.tf32(False)`` sets;
``quant="fp8"`` rounds the input and the weight of every linear layer and
convolution to float8 e4m3 with one scale per tensor (the control one
precision below the engine's bfloat16).

Departures from ``segment_anything``:
- the frame's long side is resized with ``torch``'s bilinear interpolation
  (antialiased, on float pixels), where ``ResizeLongestSide`` resizes the
  uint8 image with PIL;
- the box is scaled to the resized frame in float32 (numpy's float64 there);
- relative-position tables are used at their own size: ``get_rel_pos``
  resamples them only for a grid other than the one they were made for,
  which a 1024-pixel input never is;
- only the box prompt: no points and no mask input.
"""

import math

import torch
import torch.nn.functional as F

from .nets import _fp8

ENCODER_EPS = 1e-6
DECODER_EPS = 1e-5


class Sam:
    def __init__(self, cfg, state_dict, device, quant=None):
        """``cfg``: the configuration's ``segmenter`` block; ``state_dict``:
        tensors under ``segment_anything``'s names, kept here in float32."""
        self.cfg, self.quant = cfg, quant
        self.device = torch.device(device)
        self.p = {k: v.detach().to(device=self.device, dtype=torch.float32)
                  for k, v in state_dict.items()}

    # ---- layers -------------------------------------------------------------
    def _q(self, x, w):
        return (_fp8(x), _fp8(w)) if self.quant == "fp8" else (x, w)

    def linear(self, name, x):
        x, w = self._q(x, self.p[name + ".weight"])
        return F.linear(x, w, self.p[name + ".bias"])

    def conv(self, name, x, stride=1, padding=0):
        x, w = self._q(x, self.p[name + ".weight"])
        return F.conv2d(x, w, self.p.get(name + ".bias"), stride, padding)

    def conv_t(self, name, x):
        x, w = self._q(x, self.p[name + ".weight"])
        return F.conv_transpose2d(x, w, self.p[name + ".bias"], stride=2)

    def layer_norm(self, name, x, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"], eps)

    def layer_norm_2d(self, name, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + ENCODER_EPS)
        return self.p[name + ".weight"][:, None, None] * x + self.p[name + ".bias"][:, None, None]

    # ---- image encoder ------------------------------------------------------
    def attention(self, name, x):
        """Windowed or global attention over (B, H, W, C) with the decomposed
        relative positions, taken on the unscaled queries."""
        B, H, W, C = x.shape
        nh = self.cfg["encoder_num_heads"]
        d = C // nh
        qkv = self.linear(name + ".qkv", x).reshape(B, H * W, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nh, H * W, d)
        attn = (q * d ** -0.5) @ k.transpose(-2, -1)
        r_q = q.reshape(B * nh, H, W, d)
        Rh = _rel(H, self.p[name + ".rel_pos_h"])
        Rw = _rel(W, self.p[name + ".rel_pos_w"])
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
        attn = (attn.view(B * nh, H, W, H, W) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(B * nh, H * W, H * W)
        out = (attn.softmax(dim=-1) @ v).view(B, nh, H, W, d).permute(0, 2, 3, 1, 4)
        return self.linear(name + ".proj", out.reshape(B, H, W, C))

    def block(self, i, x):
        name = f"image_encoder.blocks.{i}"
        win = 0 if i in self.cfg["encoder_global_attn_indexes"] else self.cfg["window_size"]
        shortcut = x
        x = self.layer_norm(name + ".norm1", x, ENCODER_EPS)
        if win:
            B, H, W, C = x.shape
            ph, pw = (win - H % win) % win, (win - W % win) % win
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            x = x.view(B, Hp // win, win, Wp // win, win, C).permute(0, 1, 3, 2, 4, 5)
            x = self.attention(name + ".attn", x.reshape(-1, win, win, C))
            x = x.view(B, Hp // win, Wp // win, win, win, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            x = self.attention(name + ".attn", x)
        x = shortcut + x
        y = self.layer_norm(name + ".norm2", x, ENCODER_EPS)
        y = self.linear(name + ".mlp.lin2", F.gelu(self.linear(name + ".mlp.lin1", y)))
        return x + y

    def encode(self, img):
        """(1, 3, S, S) normalised and padded -> (1, 256, S/16, S/16)."""
        patch = self.cfg["vit_patch_size"]
        x = self.conv("image_encoder.patch_embed.proj", img, stride=patch).permute(0, 2, 3, 1)
        x = x + self.p["image_encoder.pos_embed"]
        for i in range(self.cfg["encoder_depth"]):
            x = self.block(i, x)
        x = x.permute(0, 3, 1, 2)
        x = self.layer_norm_2d("image_encoder.neck.1", self.conv("image_encoder.neck.0", x))
        return self.layer_norm_2d("image_encoder.neck.3",
                                  self.conv("image_encoder.neck.2", x, padding=1))

    # ---- prompt encoder -----------------------------------------------------
    def fourier(self, xy):
        c = (2 * xy - 1) @ self.p["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def prompt(self, box):
        """Box (4,) in the padded input's pixels -> sparse (1, 2, C), dense
        (1, C, g, g), image positions (1, C, g, g)."""
        S = self.cfg["image_size"]
        g = S // self.cfg["vit_patch_size"]
        corners = self.fourier((box + 0.5).reshape(1, 2, 2) / S)
        corners[:, 0] += self.p["prompt_encoder.point_embeddings.2.weight"][0]
        corners[:, 1] += self.p["prompt_encoder.point_embeddings.3.weight"][0]
        dense = self.p["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(1, -1, g, g)
        ones = torch.ones((g, g), device=self.device)
        y = (ones.cumsum(dim=0) - 0.5) / g
        x = (ones.cumsum(dim=1) - 0.5) / g
        pe = self.fourier(torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]
        return corners, dense, pe

    # ---- mask decoder -------------------------------------------------------
    def dec_attention(self, name, q, k, v):
        nh = self.cfg["decoder_num_heads"]
        q, k, v = (self.linear(f"{name}.{p}_proj", t) for p, t in (("q", q), ("k", k), ("v", v)))
        B, Nq, C = q.shape
        d = C // nh

        def heads(t):
            return t.reshape(B, t.shape[1], nh, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
        return self.linear(name + ".out_proj", (attn @ v).transpose(1, 2).reshape(B, Nq, C))

    def mlp(self, name, x, n):
        for i in range(n):
            x = self.linear(f"{name}.layers.{i}", x)
            if i < n - 1:
                x = F.relu(x)
        return x

    def decode(self, emb, sparse, dense, pe):
        """-> low-res logits (3, 4g, 4g) and predicted IoUs (3,) of the three
        multimask outputs."""
        t = "mask_decoder.transformer"
        tokens = torch.cat([self.p["mask_decoder.iou_token.weight"],
                            self.p["mask_decoder.mask_tokens.weight"]])[None]
        tokens = torch.cat([tokens, sparse], dim=1)
        src = emb + dense
        b, c, h, w = src.shape
        keys = src.flatten(2).permute(0, 2, 1)
        key_pe = pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for i in range(self.cfg["decoder_depth"]):
            L = f"{t}.layers.{i}"
            if i == 0:
                queries = self.dec_attention(L + ".self_attn", queries, queries, queries)
            else:
                q = queries + tokens
                queries = queries + self.dec_attention(L + ".self_attn", q, q, queries)
            queries = self.layer_norm(L + ".norm1", queries, DECODER_EPS)
            q, k = queries + tokens, keys + key_pe
            queries = queries + self.dec_attention(L + ".cross_attn_token_to_image", q, k, keys)
            queries = self.layer_norm(L + ".norm2", queries, DECODER_EPS)
            m = self.linear(L + ".mlp.lin2", F.relu(self.linear(L + ".mlp.lin1", queries)))
            queries = self.layer_norm(L + ".norm3", queries + m, DECODER_EPS)
            q, k = queries + tokens, keys + key_pe
            keys = keys + self.dec_attention(L + ".cross_attn_image_to_token", k, q, queries)
            keys = self.layer_norm(L + ".norm4", keys, DECODER_EPS)
        q, k = queries + tokens, keys + key_pe
        queries = queries + self.dec_attention(t + ".final_attn_token_to_image", q, k, keys)
        hs = self.layer_norm(t + ".norm_final_attn", queries, DECODER_EPS)
        x = keys.transpose(1, 2).reshape(b, c, h, w)
        x = self.layer_norm_2d("mask_decoder.output_upscaling.1",
                               self.conv_t("mask_decoder.output_upscaling.0", x))
        up = F.gelu(self.conv_t("mask_decoder.output_upscaling.3", F.gelu(x)))
        n_tok = self.cfg["num_multimask_outputs"] + 1
        hyper = torch.stack([self.mlp(f"mask_decoder.output_hypernetworks_mlps.{i}",
                                      hs[:, 1 + i], 3) for i in range(n_tok)], dim=1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        iou = self.mlp("mask_decoder.iou_prediction_head", hs[:, 0], self.cfg["iou_head_depth"])
        return masks[0, 1:], iou[0, 1:]

    # ---- the predictor ------------------------------------------------------
    def predict(self, rgb, box):
        """uint8 (H, W, 3) frame and one box x0, y0, x1, y1 -> (low-res logits
        (3, 4g, 4g), predicted IoUs (3,), the mask of the highest IoU at the
        frame's size)."""
        S = self.cfg["image_size"]
        img = torch.as_tensor(rgb, device=self.device).permute(2, 0, 1)[None].float()
        H, W = img.shape[2:]
        scale = S / max(H, W)
        h, w = int(H * scale + 0.5), int(W * scale + 0.5)
        img = F.interpolate(img, (h, w), mode="bilinear", align_corners=False, antialias=True)
        mean = torch.tensor(self.cfg["pixel_mean"], device=self.device).view(1, 3, 1, 1)
        std = torch.tensor(self.cfg["pixel_std"], device=self.device).view(1, 3, 1, 1)
        img = F.pad((img - mean) / std, (0, S - w, 0, S - h))
        b = torch.as_tensor(box, dtype=torch.float32) * torch.tensor([w / W, h / H, w / W, h / H])
        logits, iou = self.decode(self.encode(img), *self.prompt(b.to(self.device)))
        best = logits[int(torch.argmax(iou))][None, None]
        up = F.interpolate(best, (S, S), mode="bilinear", align_corners=False)[..., :h, :w]
        mask = F.interpolate(up, (H, W), mode="bilinear", align_corners=False)[0, 0] > 0.0
        return logits, iou, mask


# ---- weights -----------------------------------------------------------------
def param_shapes(cfg):
    """{name: (shape, kind)} of every tensor of ``segment_anything``'s state
    dict for the ``segmenter`` block ``cfg``, written out from
    ``build_sam.py`` and ``modeling/``. ``kind`` says how ``draw_weights``
    draws it: ``norm`` a norm's scale, ``rel`` a relative-position table,
    ``gauss`` the random-Fourier matrix, ``w`` anything else."""
    C, nh, p = cfg["encoder_embed_dim"], cfg["encoder_num_heads"], cfg["vit_patch_size"]
    g, D = cfg["image_size"] // p, cfg["prompt_embed_dim"]
    inner, m = D // cfg["attention_downsample_rate"], cfg["mask_in_chans"]
    n_tok = cfg["num_multimask_outputs"] + 1
    out = {}

    def add(name, *shape, kind="w"):
        out[name] = (shape, kind)

    def linear(name, n_in, n_out):
        add(name + ".weight", n_out, n_in)
        add(name + ".bias", n_out)

    def conv(name, n_in, n_out, k, bias=True, transpose=False):
        add(name + ".weight", *((n_in, n_out) if transpose else (n_out, n_in)), k, k)
        if bias:
            add(name + ".bias", n_out)

    def norm(name, n):
        add(name + ".weight", n, kind="norm")
        add(name + ".bias", n)

    def attn(name, n_inner):
        for x in "qkv":
            linear(f"{name}.{x}_proj", D, n_inner)
        linear(name + ".out_proj", n_inner, D)

    def mlp(name, widths):
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            linear(f"{name}.layers.{i}", a, b)

    e = "image_encoder"
    add(e + ".pos_embed", 1, g, g, C)
    conv(e + ".patch_embed.proj", 3, C, p)
    for i in range(cfg["encoder_depth"]):
        b = f"{e}.blocks.{i}"
        size = g if i in cfg["encoder_global_attn_indexes"] else cfg["window_size"]
        norm(b + ".norm1", C)
        add(b + ".attn.rel_pos_h", 2 * size - 1, C // nh, kind="rel")
        add(b + ".attn.rel_pos_w", 2 * size - 1, C // nh, kind="rel")
        linear(b + ".attn.qkv", C, 3 * C)
        linear(b + ".attn.proj", C, C)
        norm(b + ".norm2", C)
        linear(b + ".mlp.lin1", C, int(C * cfg["mlp_ratio"]))
        linear(b + ".mlp.lin2", int(C * cfg["mlp_ratio"]), C)
    conv(e + ".neck.0", C, D, 1, bias=False)
    norm(e + ".neck.1", D)
    conv(e + ".neck.2", D, D, 3, bias=False)
    norm(e + ".neck.3", D)

    pe = "prompt_encoder"
    add(pe + ".pe_layer.positional_encoding_gaussian_matrix", 2, D // 2, kind="gauss")
    for i in range(4):
        add(f"{pe}.point_embeddings.{i}.weight", 1, D)
    add(pe + ".not_a_point_embed.weight", 1, D)
    conv(pe + ".mask_downscaling.0", 1, m // 4, 2)
    norm(pe + ".mask_downscaling.1", m // 4)
    conv(pe + ".mask_downscaling.3", m // 4, m, 2)
    norm(pe + ".mask_downscaling.4", m)
    conv(pe + ".mask_downscaling.6", m, D, 1)
    add(pe + ".no_mask_embed.weight", 1, D)

    t = "mask_decoder.transformer"
    for i in range(cfg["decoder_depth"]):
        L = f"{t}.layers.{i}"
        attn(L + ".self_attn", D)
        norm(L + ".norm1", D)
        attn(L + ".cross_attn_token_to_image", inner)
        norm(L + ".norm2", D)
        linear(L + ".mlp.lin1", D, cfg["decoder_mlp_dim"])
        linear(L + ".mlp.lin2", cfg["decoder_mlp_dim"], D)
        norm(L + ".norm3", D)
        norm(L + ".norm4", D)
        attn(L + ".cross_attn_image_to_token", inner)
    attn(t + ".final_attn_token_to_image", inner)
    norm(t + ".norm_final_attn", D)
    md = "mask_decoder"
    add(md + ".iou_token.weight", 1, D)
    add(md + ".mask_tokens.weight", n_tok, D)
    conv(md + ".output_upscaling.0", D, D // 4, 2, transpose=True)
    norm(md + ".output_upscaling.1", D // 4)
    conv(md + ".output_upscaling.3", D // 4, D // 8, 2, transpose=True)
    for i in range(n_tok):
        mlp(f"{md}.output_hypernetworks_mlps.{i}", [D, D, D, D // 8])
    hidden = cfg["iou_head_hidden_dim"]
    mlp(md + ".iou_prediction_head", [D] + [hidden] * (cfg["iou_head_depth"] - 1) + [n_tok])
    return out


def draw_weights(cfg, seed, device):
    """Every tensor of ``param_shapes(cfg)`` in float32 on ``device``, drawn
    in that order from one generator seeded with ``seed``: a norm's scale
    1 + N(0, init_std), a relative-position table N(0, rel_pos_init_std),
    anything else N(0, init_std), each truncated at 2 sigma; the
    random-Fourier matrix standard normal, as ``segment_anything`` draws it.

    The published init leaves the relative-position tables, the position
    embedding and several tokens at zero, where a dropped one could not show.
    ``rel_pos_init_std`` (the ``segmenter`` block's) makes the bias, q . R
    over a head's channels, of the order of the attention scores, as a
    trained table's is; a table at 0.02 barely moves the attention, and a
    dropped bias then reads like bfloat16 rounding."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    out = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        t = torch.empty(shape, device=device)
        if kind == "gauss":
            t.normal_(generator=gen)
        else:
            std = cfg["rel_pos_init_std"] if kind == "rel" else cfg["init_std"]
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
            if kind == "norm":
                t.add_(1.0)
        out[name] = t
    return out


def _rel(size, table):
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + (size - 1)]
