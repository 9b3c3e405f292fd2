"""Host calls that launch a kernel or a CUDA graph on the card, from the
traced requests' trace, per frame they reconstructed: the host-dispatch
cost of the incremental loop."""
from harness.trace import LAUNCH_CALLS


def read(run):
    if run.trace is None or not run.units:
        return None
    return run.trace.count_calls(LAUNCH_CALLS) / run.units
