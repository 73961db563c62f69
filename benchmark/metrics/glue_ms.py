"""Device ms per call inside ``estimator.register`` but outside every span
that has a layer of its own: the preprocess, the crops' render and observed
side, the nets' forwards and the ICP solve (none of these nests in another,
so their sums subtract)."""

from fpbench import program

LAYERS = ("estimator.preprocess", "crop.render", "crop.observe", "refiner.net", "scorer.net",
          "geometric.solve")


def read(rec):
    whole = program.device_ms(rec, "estimator.register")
    if whole is None:
        return None
    return whole[0] - sum(rec["span_ms"].get(n, 0.0) for n in LAYERS) / rec["calls"]
