"""Share (%) of the bf16 dense peak that a call's RefineNet and ScoreNet
FLOPs take of its wall time: FLOPs counted from the forwards' input shapes
in the traced calls, wall time per call from the untraced calls of the same
window."""

from counts import nets


def read(rec):
    kept = rec["kept"]
    if not kept.get("refiner.net.forward") or not rec["wall_s_per_call"]:
        return None
    net = rec["config"]["net"]
    flops = sum(nets.refinenet(n, h, w, net) for n, h, w, _ in kept["refiner.net.forward"])
    flops += sum(nets.scorenet(n, h, w, net) for n, h, w, _ in kept.get("scorer.net.forward", []))
    per_call = flops / rec["calls"]
    return 100.0 * per_call / (rec["wall_s_per_call"] * rec["peaks"]["bf16_dense_flops"])
