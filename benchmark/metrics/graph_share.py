"""Share (%) of the traced calls' ``refiner.refine`` and ``scorer.score``
records that hold a ``graph.replay`` record: the refine and score calls that
ran as one CUDA graph launch, not as eager launches. An engine whose calls
never replay a graph reads 0."""

from fpbench import program, records

CALLS = ("refiner.refine", "scorer.score")


def read(rec):
    kept = records.named(*CALLS)
    if kept is None:
        return None
    prof = program._recorder()
    replayed = {r["parent"] for r in prof.records() if r["name"] == "graph.replay"}
    return 100.0 * sum(r["id"] in replayed for r in kept) / len(kept)
