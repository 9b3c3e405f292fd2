"""The pair grid's share of its roofline: the least time of the traced
sequences' grids (``harness/pair_grid.grid_bytes`` at F = the sequence's
frames, K = the keypoint capacity, P = the BRIEF bits and Q = the program's
counter ``loop.pairs_matched``, each grid's bits read once) over the device
time of the Hamming kernel's launches that start inside the program's
``loop.detect`` spans."""
from harness import pair_grid, program_trace, roofline


def read(run):
    grids = len(program_trace.spans(("loop.detect",)))
    q = program_trace.counters().get("loop.pairs_matched", 0)
    launches, seconds = pair_grid.kernel_time_in(run, "loop.detect")
    if not grids or not q or not launches or seconds <= 0:
        return None
    fc = run.cell.config["frontend"]
    f, k = int(run.cell.traffic["frames"]), int(fc["max_keypoints"])
    nbytes = (grids * pair_grid.grid_bytes(f, k, int(fc["num_pairs"]), 0)
              + pair_grid.grid_bytes(0, k, 0, q))
    return 100.0 * roofline.bound_s(nbytes) / seconds
