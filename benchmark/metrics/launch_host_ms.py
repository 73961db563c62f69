"""Host ms per call inside ``refiner.refine`` and ``scorer.score``: the
Python and launch calls of the refine and score loops (the host waits in
them only behind a full launch queue)."""

from fpbench import program


def read(rec):
    return program.host_ms(lambda name: name in ("refiner.refine", "scorer.score"))
