"""Stage timing, append-only run-stats log and a profiler trace scope
(port of photogrammetry_tpu/utils/profiling.py)."""
from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time

import torch


class StageTimer:
    """Accumulates wall-clock per named stage; call ``.block(x)`` inside a
    stage to wait for the device work queued so far."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()   # a Pipeline's workers share a timer

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def block(x):
        """Return ``x`` once the card has finished the work queued so far
        (``torch.cuda.synchronize``; nothing to wait for without a card)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return x

    def summary(self) -> dict[str, dict]:
        return {name: {"total_s": round(self.totals[name], 6),
                       "calls": self.counts[name],
                       "mean_s": round(self.totals[name]
                                       / max(self.counts[name], 1), 6)}
                for name in sorted(self.totals)}


def append_stats(path: str, record: dict) -> None:
    """Append a run record (timestamped, host-tagged) to a JSON-list log."""
    entry = dict(record)
    entry.setdefault("timestamp", time.time())
    entry.setdefault("hostname", socket.gethostname())
    entries = []
    if os.path.isfile(path):
        with open(path) as fh:
            try:
                entries = json.load(fh)
            except json.JSONDecodeError:
                entries = []
    entries.append(entry)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(entries, fh, indent=1)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """``torch.profiler`` trace scope (the card's activity too where there
    is one): on exit the trace is written as Chrome-trace JSON under
    ``log_dir``; a no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
