"""Wall time of the pose graph's LM solve (optimize_pose_graph): the program's
``pose_graph.solve`` span, ms over the traced sequences."""
from harness import program_trace


def read(run):
    return program_trace.span_ms(run, ("pose_graph.solve",), "seq")
