"""Wall time of the raw frames' upload a sequence: the program's
``dewarp.frames_upload`` span (the stacked frames from pageable host
memory to the card), ms over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("dewarp.frames_upload",), "seq")
