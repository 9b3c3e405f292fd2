"""Host calls that wait for the card (stream, device and event
synchronizes and synchronous copies; every blocking device-to-host read
makes one), from the traced requests' trace, per frame; the profiler's and
the spans' own synchronizes are taken out."""
from harness.trace import SYNC_CALLS


def read(run):
    if run.trace is None or not run.units:
        return None
    own = run.trace.own_syncs + run.span_syncs
    return (run.trace.count_calls(SYNC_CALLS) - own) / run.units
