"""What the program recorded of itself in a traced run: the spans and
counters of ``photogrammetry_tpu_torch.utils.profiling``, which record
while the run's ``torch.profiler`` session is active (the traced requests,
after set-up and warm-up) and never in the untraced runs.

Every reader here gives None where the program records no such span or
counter (a version of the port without them), and never raises for it.
The port is imported inside each call: the repository root is on
``sys.path`` only once a run has loaded its cell.
"""
from __future__ import annotations

import bisect
import dataclasses


def _profiling():
    """The port's profiling module where it records spans, else None."""
    try:
        from photogrammetry_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def spans(names) -> list:
    """The finished spans of the traced requests named one of ``names``."""
    prof = _profiling()
    if prof is None:
        return []
    return [s for s in prof.spans() if s.name in names and s.end is not None]


def counters() -> dict:
    """The program's counters (read from the device in one transfer)."""
    prof = _profiling()
    return prof.read_counters() if prof is not None else {}


def per(run, unit: str):
    """The divisor of a "/frame" metric (the traced requests' frames) or a
    "/seq" or "/pair" one (the traced requests)."""
    return run.units if unit == "frame" else len(run.records)


def span_ms(run, names, unit: str):
    """The summed wall time (ms) of the spans named ``names``, per frame,
    sequence or pair (``per``); None where there are none."""
    got = spans(names)
    n = per(run, unit)
    if not got or not n:
        return None
    return 1e3 * sum(s.end - s.start for s in got) / n


def device_ms_in(run, name: str, unit: str):
    """The device time (ms, per ``unit``) of the operations that start
    inside a span ``name``: the union of their intervals, clipped to the
    traced window, the spans laid on the trace's clock by
    ``host_to_trace_ns``.  The spans of ``name`` must not nest."""
    if run.trace is None:
        return None
    got = sorted((s.start, s.end) for s in spans((name,)))
    n = per(run, unit)
    if not got or not n:
        return None
    off = run.trace.host_to_trace_ns
    starts = [s * 1e9 + off for s, _ in got]
    ends = [e * 1e9 + off for _, e in got]

    def starts_inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    inside = [op for op in run.trace.ops if starts_inside(op[1])]
    return dataclasses.replace(run.trace, ops=inside).busy_s * 1e3 / n
