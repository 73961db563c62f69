"""Device ms per call in RefineNet and ScoreNet forwards: the kernels
launched inside their spans."""


def read(rec):
    spans = rec["span_ms"]
    if "refiner.net.forward" not in spans:
        return None
    return (spans["refiner.net.forward"] + spans.get("scorer.net.forward", 0.0)) / rec["calls"]
