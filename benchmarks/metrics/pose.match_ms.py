"""Wall time of matching a pair: the program's ``frontend.match`` span
(the Hamming distances, mutual-nearest matching), ms over the traced
pairs."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("frontend.match",), "pair")
