"""Wall time of the whole loop-closure stage (cli/run_sfm.close_loops_stage:
the features pass, close_loops, the re-triangulation): the program's
``sfm.loop`` span, ms over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("sfm.loop",), "seq")
