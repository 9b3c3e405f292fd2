"""Each driver rehearsed on the CPU at a cut size prints a well-formed
result line; the command refuses to run without a card."""
import _paths  # noqa: F401
import json
import os
import shutil
import subprocess
import sys

import pytest

from _tiny import rehearse
from harness import runtime

CELLS = ["sfm_picam1080.pan12", "sfm_picam1080.pan12_raw",
         "pose_lego12mp.pairs"]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_well_formed_line(cell):
    result, code = rehearse(cell)
    assert code == 0
    line = json.loads(runtime.result_line(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    cfg = runtime.load_cell(cell)
    want = {m["name"] for m in cfg.end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    # the exact comparisons hold on the plain path too
    exact = (("obs_px",) if cfg.config["driver"] == "sfm"
             else ("keypoints", "bits", "matches"))
    for name in exact:
        assert line["checks"][name]["value"] == 0


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "pose_lego12mp.pairs", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _run(_paths.ROOT, env)
    assert got.returncode != 0 and got.stdout == ""
    # a checkout of the benchmark alone: no program, no result
    shutil.copytree(_paths.BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_paths.ROOT, "BENCHMARK.json"), tmp_path)
    got = _run(tmp_path, env)
    assert got.returncode != 0 and got.stdout == ""
