"""The share of the traced sequences' bundle adjustments on the card that
replayed a cached CUDA graph of the LM loop: 100 x the program's counter
``ba.graph_replays`` / (``ba.graph_replays`` + ``ba.eager_solves``), both
host counts.  None where the program counts neither (a version of the
port without the cache)."""
from harness import program_trace


def read(run):
    got = program_trace.counters()
    replays = got.get("ba.graph_replays", 0)
    solves = replays + got.get("ba.eager_solves", 0)
    if not solves:
        return None
    return 100.0 * replays / solves
