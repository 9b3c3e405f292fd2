"""Wall time of the stage's frontend pass (precompute_frontend over the
sequence's frames): the program's ``loop.features`` span, ms over the
traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("loop.features",), "seq")
