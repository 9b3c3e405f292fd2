"""The loop-closed SfM cell: its out-and-back poses, one request at a cut
size on the CPU (a well-formed line, the exact comparisons equal, each
planted fault read as a gap), the readers of its spans and counters on
synthetic sets, and the pair grid's bytes."""
import _paths  # noqa: F401
import json
import time

import numpy as np
import pytest
import torch

import readings_loop
from harness import pair_grid, program_trace, roofline, runtime, scene
from harness.trace import DeviceTrace

CELL = "sfm_picam1080_loop.outback23"
DRIVER = runtime.load_module(runtime.BENCH_DIR / "drivers" / "sfm_loop.py",
                             "bench_driver_sfm_loop_test")


def test_out_and_back_poses():
    cell = runtime.load_cell(CELL)
    tr = cell.traffic
    spec = scene.SceneSpec(image_size=tuple(cell.config["image_size"]),
                           focal=cell.config["focal"],
                           num_frames=tr["pan_frames"],
                           pan_radius=tr["pan_radius"])
    rs, ts, centers = DRIVER.outback_trajectory(spec, tr["return_offset"])
    pan_rs, pan_ts, pan_c = scene.pan_trajectory(spec)
    assert len(rs) == tr["frames"] == 23
    np.testing.assert_array_equal(rs[:12], pan_rs)
    np.testing.assert_allclose(ts[:12], pan_ts, atol=1e-15)
    for j in range(12, 23):
        src = 22 - j                        # pan frames 10, 9, ..., 0
        np.testing.assert_array_equal(rs[j], pan_rs[src])
        np.testing.assert_allclose(centers[j] - pan_c[src],
                                   [0.0, 0.05, 0.0], atol=1e-15)
        np.testing.assert_allclose(-rs[j].T @ ts[j], centers[j],
                                   atol=1e-12)


def tiny_cell():
    """The cell at 240x320 on a 6-frame pan walked out and back."""
    cell = runtime.load_cell(CELL)
    cell.config.update(image_size=[240, 320], focal=260.0)
    cell.traffic.update(pan_frames=6, frames=11, pool=2, check_every=1,
                        warmup_requests=1, check_requests=1)
    return cell


def rehearse(seed=2 ** 31 + 7):
    torch.set_num_threads(2)
    return runtime.run_cell(tiny_cell(), seed, 0.2, False,
                            torch.device("cpu"), time.perf_counter(),
                            runtime.BENCH_DIR.parent)


def test_cpu_request_prints_a_well_formed_line():
    result, code = rehearse()
    assert code == 0
    line = json.loads(runtime.result_line(result))
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"sfm_frames_per_s", "setup_s"}
    checks = line["checks"]
    assert {"loop_counts", "loop_edges", "edge_rot_deg", "pg_cost_gap",
            "pg_decrement", "retri_px", "obs_px"} <= set(checks)
    # the exact comparisons hold on the plain path too
    for name in ("loop_counts", "loop_edges", "obs_px"):
        assert checks[name]["value"] == 0, name


@pytest.mark.parametrize("fault,number", [
    ("poses_unchanged", "pg_decrement"),
    ("counts_off_by_one", "loop_counts"),
])
def test_planted_fault_reads_as_a_gap(monkeypatch, fault, number):
    sound, _ = rehearse()
    readings_loop.LOOP_FAULTS[fault](monkeypatch.setattr)
    bad, code = rehearse()
    assert code == 0
    assert bad["checks"][number]["value"] > max(
        10 * sound["checks"][number]["value"], 1e-3)


class _Span:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end


SPANS = [_Span("sfm.loop", 1.0, 1.9), _Span("loop.features", 1.0, 1.3),
         _Span("loop.detect", 1.3, 1.5), _Span("loop.measure", 1.5, 1.6),
         _Span("pose_graph.solve", 1.6, 1.8), _Span("sfm.loop", 3.0, 3.5),
         _Span("loop.features", 3.0, 3.1), _Span("loop.detect", 3.1, 3.2),
         _Span("pose_graph.solve", 3.3, 3.4)]
COUNTERS = {"loop.pairs_matched": 2 * 529, "pose_graph.lm_iterations": 40,
            "pose_graph.lm_accepted": 30}
KERNEL = "void hamming_mma_kernel<128, 128, 64, 64, false>(...)"


@pytest.fixture
def run(monkeypatch):
    """Two traced sequences of the cell: the spans and counters above, a
    0.3 ms Hamming launch inside each ``loop.detect``, one outside."""
    monkeypatch.setattr(program_trace, "spans", lambda names: [
        s for s in SPANS if s.name in names])
    monkeypatch.setattr(program_trace, "counters", lambda: dict(COUNTERS))
    ops = [(KERNEL, 1.4e9, 300_000), (KERNEL, 3.15e9, 300_000),
           (KERNEL, 1.55e9, 50_000), ("other", 1.41e9, 1_000_000)]
    trace = DeviceTrace(ops, None, [], (0.0, 4e9), 0.0)
    cell = runtime.load_cell(CELL)
    return runtime.TracedRun(cell, [], 0, trace, [{"units": 23}] * 2)


def _reader(name):
    return runtime.load_module(runtime.BENCH_DIR / "metrics" / f"{name}.py",
                               "bench_metric_test_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,want", [
    ("loop.stage_ms", 700.0), ("loop.features_ms", 200.0),
    ("loop.detect_ms", 150.0), ("loop.measure_ms", 50.0),
    ("loop.pose_graph_ms", 150.0), ("loop.pg_accept_pct", 75.0),
])
def test_span_and_counter_readers(run, name, want):
    assert _reader(name).read(run) == pytest.approx(want)


def test_pair_grid_roofline_reader(run):
    bound = roofline.bound_s(pair_grid.grid_bytes(23, 512, 256, 529))
    assert _reader("loop.pairgrid_roofline_pct").read(run) == \
        pytest.approx(100.0 * 2 * bound / 600e-6)


def test_readers_read_none_where_nothing_was_recorded(monkeypatch, run):
    monkeypatch.setattr(program_trace, "spans", lambda names: [])
    monkeypatch.setattr(program_trace, "counters", dict)
    cell = runtime.load_cell(CELL)
    names = [m["name"] for m, _ in cell.per_layer]
    assert len(names) == 7
    for m, reader in cell.per_layer:
        assert reader.read(run) is None, m["name"]


def test_pair_grid_bytes():
    nbytes = pair_grid.grid_bytes(23, 512, 256, 529)
    assert nbytes == 23 * 512 * 257 + 529 * 512 * 512 * 4 == 557_723_136
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.1665,
                                                           abs=5e-5)
