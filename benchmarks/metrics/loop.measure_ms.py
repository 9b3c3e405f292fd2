"""Wall time of the candidates' loop-edge measurements (matching and the
trimmed Procrustes a candidate): the program's ``loop.measure`` span, ms
over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("loop.measure",), "seq")
