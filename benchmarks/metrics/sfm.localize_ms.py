"""Wall time of a mapped frame's pose a frame: the program's
``sfm.localize`` spans (the PnP rescue, motion-only BA, re-association),
ms over the traced sequences' frames."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.localize",), "frame")
