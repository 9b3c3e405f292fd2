"""Stage timing, append-only run-stats log and a profiler trace scope
(port of photogrammetry_tpu/utils/profiling.py), and the program's own
spans and counters.

Spans and counters record only while recording is on: inside a
``recording()`` scope or while a ``torch.profiler`` session is active
(the profiler's module flag ``_is_profiler_enabled``), and never while a
CUDA-graph capture is under way (``utils.graphs``: a capture runs
nothing).  Off, ``span`` is one bool test that returns a shared no-op
context.  On, it reads ``time.perf_counter()`` at entry and exit, the
clock a ``torch.profiler`` trace is aligned to.  On or off, a span or
counter never synchronizes, reads a device value, launches work or
annotates the profiler's trace: ``count`` holds a device tensor by
reference, and ``read_counters`` reads them all in one transfer after the
recorded work.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time

import torch
import torch.autograd.profiler as _torch_profiler

from photogrammetry_tpu_torch.utils import graphs as _graphs


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


# -- the program's spans and counters ---------------------------------------

MAX_SPANS = 1_000_000   # spans kept at most, and held counter tensors
DROPPED = "profiling.dropped"   # the counter of what the cap dropped

_recording = 0          # open recording() scopes
_spans: list = []
_counters: dict = {}    # name -> [host total, held 0-dim tensors]
_held = 0               # tensors held over all counters
_ids = itertools.count(1)
_local = threading.local()      # .stack: this thread's open spans


class Span:
    """A recorded span: ``start`` / ``end`` in host ``perf_counter``
    seconds (``end`` None while open), ``parent`` the enclosing span's id
    (0 at a root), ``root`` the outermost enclosing span's id (its own at
    a root), ``attrs`` as given (a tensor held by reference, unread)."""
    __slots__ = ("name", "id", "parent", "root", "attrs", "start", "end")

    def __init__(self, name, parent, attrs):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else 0
        self.root = parent.root if parent is not None else self.id
        self.start = self.end = None

    def __enter__(self):
        if len(_spans) < MAX_SPANS:
            _spans.append(self)
        else:
            _add(DROPPED, 1)
        _local.stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _local.stack.pop()
        return False


class _Off:
    """The shared context of a span taken while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@contextlib.contextmanager
def recording():
    """Spans and counters record inside this scope.  It clears nothing:
    ``clear`` does."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def is_recording() -> bool:
    """Whether spans and counters record now: recording on and no graph
    capture under way."""
    return bool(_recording or _torch_profiler._is_profiler_enabled) \
        and _graphs._ACTIVE is None


def span(name: str, **attrs):
    """A context recording ``name`` over its body while recording is on;
    off (or inside a graph capture), the shared no-op context."""
    if not is_recording():
        return _OFF
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return Span(name, stack[-1] if stack else None, attrs)


def _add(name: str, value) -> None:
    global _held
    entry = _counters.setdefault(name, [0, []])
    if not isinstance(value, torch.Tensor):
        entry[0] += value
    elif _held < MAX_SPANS:
        entry[1].append(value)
        _held += 1
    else:
        _add(DROPPED, 1)


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while recording is on: a host
    number, or a 0-dim tensor held by reference (no launch, no read)."""
    if is_recording():
        _add(name, value)


def read_counters() -> dict:
    """Each counter's total: its host part plus its held tensors, those
    summed with one stack a counter and read in one transfer.  The read
    waits for the device: call it after the recorded work."""
    sums = {name: torch.stack(held).sum(dtype=torch.float64)
            for name, (_, held) in _counters.items() if held}
    read = {}
    if sums:
        dev = next(iter(sums.values())).device
        read = dict(zip(sums, torch.stack([s.to(dev) for s in
                                           sums.values()]).tolist()))
    out = {}
    for name, (total, _) in _counters.items():
        v = total + read.get(name, 0)
        out[name] = int(v) if float(v).is_integer() else v
    return out


def spans() -> list:
    """The recorded spans, in the order they began."""
    return list(_spans)


def clear() -> None:
    """Empty the span buffer and the counters."""
    global _held
    _spans.clear()
    _counters.clear()
    _held = 0


def span_summary() -> dict:
    """Per name, over the finished spans: ``calls``, ``total_s`` and
    ``self_s`` (each span's duration less the part its children cover)."""
    done = [sp for sp in _spans if sp.end is not None]
    covered: dict = {}
    for sp in done:
        if sp.parent:
            covered[sp.parent] = covered.get(sp.parent, 0.0) \
                + (sp.end - sp.start)
    out: dict = {}
    for sp in done:
        row = out.setdefault(sp.name, {"calls": 0, "total_s": 0.0,
                                       "self_s": 0.0})
        row["calls"] += 1
        row["total_s"] += sp.end - sp.start
        row["self_s"] += sp.end - sp.start - covered.get(sp.id, 0.0)
    return {name: out[name] for name in sorted(out)}
