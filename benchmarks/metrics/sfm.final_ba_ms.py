"""Wall time of the final BA a sequence: the program's
``sfm.final_ba`` span (its rounds with re-triangulation and pruning), ms
over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.final_ba",), "seq")
