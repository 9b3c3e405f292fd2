"""Wall time of the dewarp's distortion map a sequence: the program's
``dewarp.map_load`` (the cached ``.npz`` read, or its generation) and
``dewarp.map_upload`` (the map moved to the card) spans, ms over the
traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(
        run, ("dewarp.map_load", "dewarp.map_upload"), "seq")
