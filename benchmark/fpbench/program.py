"""What the engine's own spans give the per-layer readers.

The engine marks the phases of ``register`` and ``track_one`` itself
(``foundationpose_tpu_torch.utils.profiling.span``): while the profiler
records, each phase is a ``record_function`` range in the trace, so the
trace's reduction charges it the kernels launched inside it
(``rec["span_ms"]``), and a record in the engine's memory holds its host
start and end. The traced calls run in this process, so the readers take
those records from the engine's module after the calls.

An engine without the spans (a checkout from before them) reads None; one
that has them but left none in the trace or in its records fails the run
(``NoSpans``), as a trace without kernels does: neither reads 0.
"""

CALLS = ("estimator.register", "estimator.track_one")  # the outermost span of a call


class NoSpans(RuntimeError):
    """The engine has spans, but the traced calls left none of those read."""


def _recorder():
    """The engine's span module, or None for an engine without spans."""
    from foundationpose_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "records") else None


def device_ms(rec, *names):
    """Device ms per call of the kernels launched inside each named span
    (a list, in order), or None for an engine without spans."""
    if _recorder() is None:
        return None
    missing = [n for n in names if n not in rec["span_ms"]]
    if missing:
        raise NoSpans(f"no kernel was launched inside the spans {missing}")
    return [rec["span_ms"][n] / rec["calls"] for n in names]


def host_ms(keep):
    """Host ms per call spent in the records whose name ``keep`` accepts,
    over the traced calls' records (divided by the number of calls), or
    None for an engine without spans."""
    prof = _recorder()
    if prof is None:
        return None
    recs = prof.records()
    calls = {r["call"] for r in recs if r["parent"] is None and r["name"] in CALLS}
    if not calls:
        raise NoSpans(f"the engine kept no record of a call ({' or '.join(CALLS)})")
    kept = [r for r in recs if r["call"] in calls and keep(r["name"])]
    if not kept:
        raise NoSpans("the traced calls left no record of the spans read")
    return sum(r["end_ns"] - r["start_ns"] for r in kept) / 1e6 / len(calls)
