"""Device ms per call in the segmenter (``sam.segment``: pre-process,
encoder, neck, prompt, decoder, post-process)."""

from fpbench import program


def read(rec):
    ms = program.device_ms(rec, "sam.segment")
    return None if ms is None else ms[0]
