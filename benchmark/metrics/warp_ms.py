"""Device ms per call in the observed crop warp."""


def read(rec):
    ms = rec["span_ms"].get("imops.warp_crop_affine")
    return None if ms is None else ms / rec["calls"]
