"""One run of one cell: find the cell's files by name, set up, drive the
closed loop for the window, read the per-layer metrics of a traced run,
check the outputs against the plain reference and print the result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is found by name under the benchmark's folder:
``configs/<config>.json`` (which names its driver), ``traffic/<mix>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``; a cell is an entry of
``workloads`` in ``BENCHMARK.json`` at the folder's parent.

A driver module has ``make(ctx)`` returning an object with ``setup()``,
``request(i) -> dict`` (``ok``, ``units``, optionally a ``note`` that
the run logs; what the check needs),
``end_to_end(records, window_start) -> dict`` and ``check(records,
control=False) -> list of (name, value, limit)``.  A metric module has
``read(run) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from harness.trace import Profiler, Spans

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "photogrammetry_tpu")


def cache_env(root: Path) -> dict:
    """The fixed directories inside the checkout that hold every build and
    kernel cache of a run (the port's nvcc builds go to its own fixed
    ``build/photogrammetry_tpu_torch`` there)."""
    base = root / "build" / "bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "USE_FLAX": "0"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell's entry, configuration, traffic, driver and the metrics it
    reports, found by name."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    driver: object
    end_to_end: list
    per_layer: list      # (metric entry, reader module)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, every cell
    where it lists none (as ``setup_s``)."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              benchmark: dict | None = None) -> Cell:
    bench = benchmark or load_json(bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(bench_dir.parent / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    driver = load_module(bench_dir / "drivers" / f"{config['driver']}.py",
                         f"bench_driver_{config['driver']}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [(m, load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_")))
                 for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, entry, config, traffic, driver, e2e, per_layer)


@dataclasses.dataclass
class Context:
    """What a driver is given."""
    cell: Cell
    seed: int
    device: object
    spans: Spans
    root: Path

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class TracedRun:
    """What a per-layer metric reader reads."""
    cell: Cell
    spans: list
    span_syncs: int
    trace: object          # harness.trace.DeviceTrace, None off the card
    records: list          # the traced requests' records

    @property
    def units(self) -> int:
        return sum(r["units"] for r in self.records)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, root: Path) -> tuple[dict, int]:
    """One run: (the result line's object, exit code)."""
    import torch

    spans = Spans(trace, device)
    ctx = Context(cell, seed, device, spans, root)
    driver = cell.driver.make(ctx)
    driver.setup()
    spans.items.clear()          # the warm-up's
    spans.syncs = 0
    on_card = device.type == "cuda"
    traced_requests = int(cell.traffic.get("trace_requests", 0)) or None
    profiler = Profiler(device) if (trace and on_card) else None
    if profiler:
        profiler.start()          # CUPTI's start-up is not in the window
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    records = []
    window_start = time.perf_counter()
    setup_s = window_start - t_process
    device_trace = None
    i = 0
    while time.perf_counter() - window_start < seconds:
        t0 = time.perf_counter()
        rec = driver.request(i)
        rec.update(index=i, t0=t0, t1=time.perf_counter())
        records.append(rec)
        i += 1
        if profiler and device_trace is None and i == traced_requests:
            device_trace = profiler.stop()
    if profiler and device_trace is None:
        device_trace = profiler.stop()
    window_end = time.perf_counter()
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)

    failed = sum(not r["ok"] for r in records)
    result = {"correct": False, "attempted": len(records), "failed": failed}
    metrics = {}
    if not trace:
        values = driver.end_to_end(records, window_start)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        traced = records[:traced_requests] if traced_requests else records
        run = TracedRun(cell, spans.items, spans.syncs, device_trace, traced)
        for m, reader in cell.per_layer:
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": memory_peak}
    if device_trace is not None:
        log("host calls in the trace: " + ", ".join(
            f"{k} {v}" for k, v in device_trace.calls.most_common(12)))
        result["device"].update(busy_s=device_trace.busy_s,
                                window_s=device_trace.window_s)
        result["breakdown"] = {
            "device_ops": device_trace.top_ops(10),
            "idle_gaps": device_trace.idle_gaps(spans.items, 10)}

    log(f"window {window_end - window_start:.3f} s, {len(records)} requests,"
        f" {failed} failed, setup {setup_s:.3f} s")
    for r in records:               # a driver's note on each request
        if "note" in r:
            log(f"request {r['index']}: {r['t1'] - r['t0']:.4f} s, "
                f"{r['note']}")
    times = sorted(r["t1"] - r["t0"] for r in records)
    if times:
        log(f"request s: min {times[0]:.4f} median {times[len(times) // 2]:.4f}"
            f" max {times[-1]:.4f}")

    checks = driver.check(records)
    result["correct"] = bool(checks) and all(v <= lim for _, v, lim in checks)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v in getattr(driver, "info", {}).items():
        log(f"{name}: {v}")
    for name, v, lim in checks:           # the last lines on stderr
        log(f"check {name}: {v!r} limit {lim!r}")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return {}, 3
    return result, 0


def process_start() -> float:
    """The perf_counter time at which this process started (to the 10 ms
    of the kernel's clock ticks), from /proc; now where that is absent."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def main(argv=None) -> int:
    import argparse

    t_process = process_start()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = BENCH_DIR.parent
    os.environ.update(cache_env(root))
    cell = load_cell(args.workload)
    sys.path.insert(0, str(root))
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    result, code = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, t_process, root)
    if code:
        return code
    print(result_line(result), flush=True)
    return 0


def result_line(result: dict) -> str:
    """The result as the run's last line: JSON, the compared numbers with
    their limits last."""
    out = {k: v for k, v in result.items() if k != "checks"}
    out["checks"] = result["checks"]
    return json.dumps(out)
