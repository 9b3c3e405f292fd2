"""The Schur-products kernel's share of its roofline: the least time of
its calls at the shape the SfM path runs it (F = the sequence's frames,
T = the track capacity), over the device time of its two passes
(schur_partial_kernel, schur_reduce_kernel) in the trace."""
from harness import roofline


def read(run):
    if run.trace is None:
        return None
    calls, partial_s = run.trace.kernel_times("schur_partial_kernel")
    _, reduce_s = run.trace.kernel_times("schur_reduce_kernel")
    if not calls or partial_s + reduce_s <= 0:
        return None
    f = int(run.cell.traffic["frames"])
    t = int(run.cell.config["sfm"]["track_capacity"])
    bound = roofline.bound_s(roofline.schur_bytes(f, t),
                             roofline.schur_ops(f, t))
    return 100.0 * calls * bound / (partial_s + reduce_s)
