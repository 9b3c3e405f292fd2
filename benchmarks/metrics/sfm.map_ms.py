"""Wall time of the map update a frame: the program's ``sfm.map``
spans (triangulation, windowed BA, the gauge, pruning), ms over the
traced sequences' frames."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.map",), "frame")
