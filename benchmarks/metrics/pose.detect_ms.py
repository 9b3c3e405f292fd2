"""Wall time of detection a pair: the program's ``frontend.detect``
spans (FAST, the strongest slots, NMS, the subpixel refine) of both
frames, ms over the traced pairs."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("frontend.detect",), "pair")
