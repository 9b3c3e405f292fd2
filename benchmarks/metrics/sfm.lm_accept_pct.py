"""The share of LM iterations whose step was accepted, over every
bundle adjustment of the traced sequences: 100 x the program's counter
``ba.lm_accepted`` (each iteration's accept flag, read once after the
window) / ``ba.lm_iterations``."""
from harness import program_trace


def read(run):
    got = program_trace.counters()
    if not got.get("ba.lm_iterations"):
        return None
    return 100.0 * got.get("ba.lm_accepted", 0) / got["ba.lm_iterations"]
