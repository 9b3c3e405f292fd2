"""The control (the reference in bfloat16, one step below the
configuration's float32, put in the program's place) comes out not
correct, at a size the CPU holds; on the card, ``benchmarks/readings.py``
takes the same readings at the cells' own sizes.  The program's own
readings there pass every exact comparison."""
import _paths  # noqa: F401
import pytest
import torch

import readings
from _tiny import tiny_cell
from harness import runtime


@pytest.mark.parametrize("cell", ["sfm_picam1080.pan12",
                                  "sfm_picam1080.pan12_raw",
                                  "pose_lego12mp.pairs"])
def test_control_fails_and_program_passes_exact(cell):
    torch.set_num_threads(2)
    c = tiny_cell(cell)
    limits = c.config["limits"]
    got = readings.readings(c, 2 ** 31 + 3, torch.device("cpu"),
                            runtime.BENCH_DIR.parent, control=True)
    assert got["failed"] == 0
    ctrl = got["control"]
    assert any(v > limits[k] for k, v in ctrl.items()), ctrl
    prog = got["program"]
    if c.config["driver"] == "sfm":
        assert ctrl["obs_px"] > limits["obs_px"]
        assert prog["obs_px"] == 0
    else:
        assert ctrl["xy_px"] > limits["xy_px"]
        assert all(prog[k] == 0 for k in ("keypoints", "bits", "matches"))
