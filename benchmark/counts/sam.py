"""Multiply-add FLOPs (2 per multiply-add) and least times of Segment
Anything on box prompts, from the configuration's widths (``segmenter``
block; ``models/sam.py``'s names). A dense layer is 2 x rows x in x out, a
convolution 2 x outputs x C_out x k^2 x C_in, attention 2 x L x S x d for the
scores and again for the weighted sum, the decomposed relative positions 2 x
L x side x d for each of their two einsums. In a windowed block the qkv and
output projections run on the padded grid (70 x 70 tokens at ViT-H's 64 x 64
with 14 x 14 windows), the MLP on the grid itself. Norms, activations,
softmax, the resizes and the bias's broadcast add are left out."""

import math

BYTES = 2  # bfloat16


def dense(rows, din, dout):
    return 2 * rows * din * dout


def attention(batch, tokens, side, head_dim):
    """Scores, weighted sum and the two relative-position einsums of
    ``batch`` attention instances (windows x heads) over ``tokens`` = side^2."""
    return 4 * batch * tokens * tokens * head_dim + 4 * batch * tokens * side * head_dim


def attn_blocks(cfg):
    """(is_global, batch, tokens, side) of each encoder block's attention."""
    g, w, heads = cfg["image_size"] // cfg["vit_patch_size"], cfg["window_size"], \
        cfg["encoder_num_heads"]
    out = []
    for i in range(cfg["encoder_depth"]):
        if i in cfg["encoder_global_attn_indexes"]:
            out.append((True, heads, g * g, g))
        else:
            n_win = math.ceil(g / w) ** 2
            out.append((False, n_win * heads, w * w, w))
    return out


def encoder(cfg):
    """Patch embedding, the blocks and the neck of one image."""
    D, p = cfg["encoder_embed_dim"], cfg["vit_patch_size"]
    g = cfg["image_size"] // p
    n, dh = g * g, D // cfg["encoder_num_heads"]
    hidden = int(D * cfg["mlp_ratio"])
    C = cfg["prompt_embed_dim"]
    total = dense(n, 3 * p * p, D)
    for is_global, batch, tokens, side in attn_blocks(cfg):
        rows = n if is_global else batch // cfg["encoder_num_heads"] * tokens
        total += dense(rows, D, 3 * D) + dense(rows, D, D) + attention(batch, tokens, side, dh)
        total += dense(n, D, hidden) + dense(n, hidden, D)
    return total + dense(n, D, C) + dense(n, 9 * C, C)


def _cross(t, n, C, inner):
    """Attention of t queries over n keys at inner width ``inner``:
    projections, scores and weighted sum."""
    return dense(t, C, inner) + 2 * dense(n, C, inner) + dense(t, inner, C) + 4 * t * n * inner


def decoder(cfg, boxes=1):
    """Prompt encoding and mask decoding of ``boxes`` box prompts."""
    C, g = cfg["prompt_embed_dim"], cfg["image_size"] // cfg["vit_patch_size"]
    n, inner = g * g, C // cfg["attention_downsample_rate"]
    m = cfg["num_multimask_outputs"] + 1
    t = 1 + m + 2  # IoU token, mask tokens, two box corners
    pe = dense(n, 2, C // 2)
    layer = (4 * dense(t, C, C) + 4 * t * t * C + _cross(t, n, C, inner)
             + dense(t, C, cfg["decoder_mlp_dim"]) * 2 + _cross(n, t, C, inner))
    trunk = cfg["decoder_depth"] * layer + _cross(t, n, C, inner)
    up = 2 * n * C * (C // 4) * 4 + 2 * (4 * n) * (C // 4) * (C // 8) * 4
    heads = m * (2 * dense(1, C, C) + dense(1, C, C // 8)) + 2 * dense(1, C, C) + dense(1, C, m)
    masks = 2 * m * (C // 8) * 16 * n
    return pe + boxes * (trunk + up + heads + masks)


def flops(cfg, boxes=1):
    """One ``BoxSegmenter`` call: one image and ``boxes`` box prompts."""
    return encoder(cfg) + decoder(cfg, boxes)


def attn_bound(batch, tokens, side, head_dim, peaks):
    """Least time of one block's attention (seconds, bytes, FLOPs): the
    FLOPs at the bf16 peak against q, k, v read once, the output written
    once and the two relative-position tables read once, at the HBM rate,
    whichever is larger. The bias is no input of the attention: it is made
    from q and the tables, so a kernel that never writes it out needs none
    of its bytes."""
    ops = attention(batch, tokens, side, head_dim)
    tables = 2 * (2 * side - 1) * head_dim
    nbytes = BYTES * (4 * batch * tokens * head_dim + tables)
    return max(ops / peaks["bf16_dense_flops"], nbytes / peaks["hbm_bytes_per_s"]), nbytes, ops
