"""The share of the pose graph's LM iterations whose step was accepted,
over the traced sequences' solves: 100 x the program's counter
``pose_graph.lm_accepted`` (each iteration's accept flag, held on the
device and read once after the window) / ``pose_graph.lm_iterations``."""
from harness import program_trace


def read(run):
    got = program_trace.counters()
    if not got.get("pose_graph.lm_iterations"):
        return None
    return (100.0 * got.get("pose_graph.lm_accepted", 0)
            / got["pose_graph.lm_iterations"])
