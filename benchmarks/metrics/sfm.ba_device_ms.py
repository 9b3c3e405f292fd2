"""Device time of bundle adjustment a frame: the union of the device
operations whose start falls inside one of the program's ``ba.solve``
spans (every LM solve, under whichever stage called it), ms over the
traced sequences' frames.

An operation is put down to the span in which it starts on the card, not
the one that launched it.  With the card idle ~89% of the SfM window, an
operation starts within microseconds of its launch, so the two agree but
for the few launched at a span's edges."""
from harness import program_trace


def read(run):
    return program_trace.device_ms_in(run, "ba.solve", "frame")
