"""Wall time of place recognition: the pair grid's counts, their read to the
host and the candidate selection: the program's ``loop.detect`` span, ms
over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("loop.detect",), "seq")
