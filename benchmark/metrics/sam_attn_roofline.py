"""Share (%) of their least time that the segmenter's attentions take: the
summed least times (``counts/sam.attn_bound``, from each ``sam.attn.window``
and ``sam.attn.global`` span's ``n`` attention instances of ``size`` tokens
and the configuration's head width) over the device time of the kernels
launched inside those spans (the relative-position bias and the attention
itself; not the qkv and output projections)."""

from counts import sam
from fpbench import program, records

NAMES = ("sam.attn.window", "sam.attn.global")


def read(rec):
    spans = records.named(*NAMES)
    if spans is None:
        return None
    device_s = sum(program.device_ms(rec, *NAMES)) * rec["calls"] / 1e3
    cfg = rec["config"]["segmenter"]
    head_dim = cfg["encoder_embed_dim"] // cfg["encoder_num_heads"]
    least = sum(sam.attn_bound(r["n"], r["size"], round(r["size"] ** 0.5), head_dim,
                               rec["peaks"])[0] for r in spans)
    return 100.0 * least / device_s
