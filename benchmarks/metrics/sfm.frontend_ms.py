"""Wall time of the SfM frontend a sequence: the program's
``sfm.frontend`` span (frame upload, the batched detect and describe,
``precompute_matching`` where it is on), ms over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.frontend",), "seq")
