"""The engine's own span records of the traced calls, by name, for readers
that count work from the shapes a span kept (``n``, ``size``;
``utils/profiling.span``). Only the traced calls run while the profiler
records, so every record is theirs.

An engine without the spans reads None; one that has them but kept none of
the name fails the run (``program.NoSpans``), as ``program.device_ms`` does.
"""

from . import program


def named(*names):
    """The records whose name is one of ``names``, in the order entered."""
    prof = program._recorder()
    if prof is None:
        return None
    recs = [r for r in prof.records() if r["name"] in names]
    if not recs:
        raise program.NoSpans(f"the traced calls left no record of the spans {list(names)}")
    return recs
