"""Device ms per call in the engine's frame preprocess (``estimator.preprocess``:
uploads, the mask gate, erode + bilateral + xyz map)."""

from fpbench import program


def read(rec):
    ms = program.device_ms(rec, "estimator.preprocess")
    return None if ms is None else ms[0]
