"""On the card: a short run of each cell through the command prints a
correct, well-formed last line.  Marked ``cuda``; skips without a card
(decided inside the test)."""
import _paths  # noqa: F401
import json
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["pose_lego12mp.pairs",
                                  "sfm_picam1080.pan12"])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=_paths.ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("cell", ["pose_lego12mp.pairs"])
def test_tf32_control_fails_on_the_card(cell):
    """The program with PyTorch's TF32 matmuls switched on (the control
    one step below the configuration's float32) fails a number, at the
    cell's own size.  (In the SfM cells it fails ``cost_gap_px2``:
    ``benchmarks/readings.py --tf32-seeds`` reads it there.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import readings
    from harness import runtime

    c = runtime.load_cell(cell)
    limits = c.config["limits"]
    got = readings.readings(c, 2 ** 31 + 11, torch.device("cuda", 0),
                            runtime.BENCH_DIR.parent, tf32=True)
    assert any(v > limits[k] for k, v in got["program"].items()), got
