"""The share of the traced sequences' pose-graph solves on the card that
replayed a cached CUDA graph of the LM loop: 100 x the program's counter
``pose_graph.graph_replays`` / (``pose_graph.graph_replays`` +
``pose_graph.eager_solves``), both host counts.  None where the program
counts neither (a version of the port without the cache)."""
from harness import program_trace


def read(run):
    got = program_trace.counters()
    replays = got.get("pose_graph.graph_replays", 0)
    solves = replays + got.get("pose_graph.eager_solves", 0)
    if not solves:
        return None
    return 100.0 * replays / solves
