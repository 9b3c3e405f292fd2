"""The readers of the program's own spans and counters, each on one
request of its cell cut to the CPU tests' size (``_tiny``) and recorded
under ``profiling.recording()``: a positive value; and None from every
one where the program recorded nothing."""
import _paths  # noqa: F401
import json
import pathlib

import pytest
import torch

from _tiny import tiny_cell
from harness import runtime
from harness.trace import DeviceTrace, Spans

BENCH = json.loads((pathlib.Path(_paths.ROOT) / "BENCHMARK.json")
                   .read_text())
READERS = ("program_span", "program_counter")
NEW = {"sfm.ba_device_ms"} | {m["name"] for m in BENCH["per_layer"]
                              if m["source"] in READERS}
CELLS = sorted({w for m in BENCH["per_layer"] if m["name"] in NEW
                for w in m["workloads"]})


def _trace_over(spans, name):
    """A device trace on the host clock (offset 0) with one 2 us operation
    starting inside the first span ``name`` and one before every span."""
    inside = next(s for s in spans if s.name == name)
    t0 = min(s.start for s in spans) * 1e9
    start = (inside.start + inside.end) / 2 * 1e9
    ops = [("before", t0 - 5000, 1000), ("inside", start, 2000)]
    return DeviceTrace(ops, None, [], (t0 - 1e4, start + 1e4), 0.0)


@pytest.fixture(scope="module", params=CELLS)
def readings(request):
    """(cell, {metric: value}) of one recorded request, and the values
    with nothing recorded."""
    from photogrammetry_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    cell = tiny_cell(request.param)
    dev = torch.device("cpu")
    ctx = runtime.Context(cell, 2 ** 31 + 11, dev, Spans(False, dev),
                          runtime.BENCH_DIR.parent)
    driver = cell.driver.make(ctx)
    driver.setup()
    profiling.clear()
    with profiling.recording():
        rec = driver.request(0)
    assert rec["ok"]
    spans = profiling.spans()
    trace = (_trace_over(spans, "ba.solve")
             if any(s.name == "ba.solve" for s in spans) else None)
    run = runtime.TracedRun(cell, [], 0, trace, [rec])
    got = {m["name"]: reader.read(run) for m, reader in cell.per_layer
           if m["name"] in NEW}
    profiling.clear()
    empty = runtime.TracedRun(cell, [], 0, trace, [rec])
    none = {m["name"]: reader.read(empty) for m, reader in cell.per_layer
            if m["name"] in NEW}
    return cell, got, none


def test_every_new_reader_reads_a_positive_value(readings):
    cell, got, _ = readings
    want = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and cell.name in m["workloads"]}
    assert set(got) == want and want
    for name, value in got.items():
        assert value is not None and value > 0, name
    if "sfm.ba_device_ms" in got:       # the 2 us inside, over the frames
        assert got["sfm.ba_device_ms"] == pytest.approx(
            2e-3 / cell.traffic["frames"])
    if "sfm.lm_accept_pct" in got:
        assert got["sfm.lm_accept_pct"] <= 100


def test_nothing_recorded_reads_none(readings):
    _, _, none = readings
    assert none and all(v is None for v in none.values())
