"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a new cell added as new files plus a ``workloads``
entry alone."""
import _paths  # noqa: F401
import json
import pathlib
import re
import shutil
import time

import pytest
import torch

from harness import runtime

ROOT = pathlib.Path(_paths.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for w in m.get("workloads", []):
            assert w in CELLS
            # the cells it lists report the metric it moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)


def test_configs_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmarks/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    got = runtime.load_cell(cell)
    assert hasattr(got.driver, "make")
    names = {m["name"] for m in got.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert got.per_layer
    for _, reader in got.per_layer:
        assert callable(reader.read)
    assert got.entry["chips"] == 1


def test_new_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark folder gains a configuration and a traffic
    mix as new files and a cell as a new workloads entry; the harness runs
    it without an edit to any file that was there."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(_paths.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs" / "pose_lego12mp.json").read_text())
    cfg.update(name="pose_vga", image_size=[480, 640], focal=520.0)
    (bench / "configs" / "pose_vga.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "pairs.json").read_text())
    traffic.update(pool=2, warmup_requests=1, check_requests=2,
                   check_every=1)
    (bench / "traffic" / "pairs_small.json").write_text(json.dumps(traffic))
    new = json.loads(json.dumps(BENCH))
    new["configs"].append({"name": "pose_vga", "source": "x",
                           "file": "benchmarks/configs/pose_vga.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "pose_vga.pairs_small",
                             "config": "pose_vga", "traffic": "pairs_small",
                             "chips": 1, "why": "a test"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "pose_lego12mp.pairs" in m.get("workloads", []):
            m["workloads"].append("pose_vga.pairs_small")
    cell = runtime.load_cell("pose_vga.pairs_small", bench, new)
    assert cell.config["image_size"] == [480, 640]
    torch.set_num_threads(2)
    result, code = runtime.run_cell(cell, 11, 0.3, False,
                                    torch.device("cpu"), time.perf_counter(),
                                    tmp_path)
    assert code == 0
    line = json.loads(runtime.result_line(result))
    assert {"pose_p50_ms", "pose_p95_ms", "setup_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
