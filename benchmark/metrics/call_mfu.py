"""Share (%) of the bf16 dense peak that a call's FLOPs take of its wall
time: RefineNet and ScoreNet FLOPs from the forwards' input shapes
(``counts/nets.py``) plus the segmenter's (``counts/sam.py``, per
``sam.segment`` span) in the traced calls, per call, over the wall time per
call of the untraced calls of the same window."""

from counts import nets, sam
from fpbench import records


def read(rec):
    kept = rec["kept"]
    spans = records.named("sam.segment")
    if spans is None or not kept.get("refiner.net.forward") or not rec["wall_s_per_call"]:
        return None
    net = rec["config"]["net"]
    flops = sum(nets.refinenet(n, h, w, net) for n, h, w, _ in kept["refiner.net.forward"])
    flops += sum(nets.scorenet(n, h, w, net) for n, h, w, _ in kept.get("scorer.net.forward", []))
    flops += sum(sam.flops(rec["config"]["segmenter"], r["n"]) for r in spans)
    per_call = flops / rec["calls"]
    return 100.0 * per_call / (rec["wall_s_per_call"] * rec["peaks"]["bf16_dense_flops"])
