"""The FAST kernel's share of its roofline: the least time of a launch on
one frame at the configuration's photo size (its bytes: float32 in, int32
out), over the device time of its launches (fast_score_kernel) in the
trace."""
from harness import roofline


def read(run):
    if run.trace is None:
        return None
    calls, seconds = run.trace.kernel_times("fast_score_kernel")
    if not calls or seconds <= 0:
        return None
    h, w = run.cell.config["image_size"]
    bound = roofline.bound_s(roofline.fast_bytes(1, h, w))
    return 100.0 * calls * bound / seconds
