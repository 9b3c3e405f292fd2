"""Wall time of track chaining a frame: the program's ``sfm.track``
spans (matching to t-1 and t-2, the epipolar gates, chaining), ms over
the traced sequences' frames."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.track",), "frame")
