"""Host ms per call in spans whose names end in ``.wait``: the engine's
host reads of device values, where the host waits for the card."""

from fpbench import program


def read(rec):
    return program.host_ms(lambda name: name.endswith(".wait"))
