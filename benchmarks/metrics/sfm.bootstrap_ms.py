"""Wall time of the map's bootstrap a sequence: the program's
``sfm.bootstrap`` span (the two-view RANSAC attempts, PnP of the
intermediate frames, each attempt's BA, the arbitration), ms over the
traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.bootstrap",), "seq")
