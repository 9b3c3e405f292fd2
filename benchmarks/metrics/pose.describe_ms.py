"""Wall time of description a pair: the program's ``frontend.describe``
spans (BRIEF) of both frames, ms over the traced pairs."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("frontend.describe",), "pair")
