"""Share (%) of the bf16 dense peak that the segmenter's FLOPs take of its
device time: FLOPs of every ``sam.segment`` span of the traced calls
(``counts/sam.py``, one image and the span's ``n`` boxes each) over the
device time of the kernels launched inside them."""

from counts import sam
from fpbench import program, records


def read(rec):
    spans = records.named("sam.segment")
    if spans is None:
        return None
    ms = program.device_ms(rec, "sam.segment")[0] * rec["calls"]
    flops = sum(sam.flops(rec["config"]["segmenter"], r["n"]) for r in spans)
    return 100.0 * flops / (ms / 1e3 * rec["peaks"]["bf16_dense_flops"])
