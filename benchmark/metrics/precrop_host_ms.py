"""Host ms per tracked frame in ``estimator.precrop``: the input checks, the
numpy pre-crop round the last pose and the depth quantisation."""

from fpbench import program


def read(rec):
    return program.host_ms(lambda name: name == "estimator.precrop")
