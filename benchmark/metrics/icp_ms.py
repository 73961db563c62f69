"""Device ms per call in the ICP's normal equations and solve."""


def read(rec):
    ms = rec["span_ms"].get("geometric._point_to_plane_delta")
    return None if ms is None else ms / rec["calls"]
