"""Share (%) of their least time that the traced calls' K1s + K1r launches
take: summed bounds (counts/k1.py) over the summed device time of the
kernels launched in the two launch calls' spans."""

from counts import k1


def read(rec):
    setups = rec["kept"].get("raster_cuda.setup_cuda")
    rasters = rec["kept"].get("raster_cuda.rasterize_cuda")
    spans = rec["span_ms"]
    if not setups or len(setups) != len(rasters):
        return None
    device_s = (spans.get("raster_cuda.setup_cuda", 0.0)
                + spans.get("raster_cuda.rasterize_cuda", 0.0)) / 1e3
    if device_s <= 0:
        return None
    least = sum(k1.bound({**s, **r}, rec["peaks"])[0] for s, r in zip(setups, rasters))
    return 100.0 * least / device_s
