"""``readings.py`` for the loop-closed SfM cell, with the faults planted in
the loop-closure stage beside the SfM loop's:

    python benchmarks/readings_loop.py --workload sfm_picam1080_loop.outback23 \
        --seeds 1 2 3 ... [--control-seeds ...] [--tf32-seeds ...] \
        [--fault poses_unchanged --fault-seeds 7 8 9] [--out readings.jsonl]

Each seed prints one JSON line of the numbers a run of the cell compares
(``drivers/sfm_loop.py``); the benchmark's own runs never run this.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import readings  # noqa: E402


def _poses_unchanged(plant):
    """``close_loops`` solves its graph but hands back the poses it was
    given (with the solve's costs)."""
    from photogrammetry_tpu_torch.sfm import loop_closure

    orig = loop_closure.close_loops

    def unchanged(features, rs, ts, *args, **kwargs):
        return (rs, ts) + orig(features, rs, ts, *args, **kwargs)[2:]

    plant(loop_closure, "close_loops", unchanged)


def _counts_off_by_one(plant):
    """The pair grid's (F, F) counts come out of ``pairwise_match_counts``
    one higher each."""
    from photogrammetry_tpu_torch.sfm import loop_closure

    orig = loop_closure.pairwise_match_counts

    def off_by_one(*args, **kwargs):
        return orig(*args, **kwargs) + 1

    plant(loop_closure, "pairwise_match_counts", off_by_one)


LOOP_FAULTS = {"poses_unchanged": _poses_unchanged,
               "counts_off_by_one": _counts_off_by_one}

if __name__ == "__main__":
    readings.FAULTS.update(LOOP_FAULTS)
    sys.exit(readings.main())
