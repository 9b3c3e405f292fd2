"""What a traced run records: the benchmark's own spans around its calls
into the port, and the ``torch.profiler`` trace of the card reduced to
what the per-layer readers take from it.

Spans end in a device synchronize when tracing is on, and are free (no
record, no synchronize) when it is off, so that the untraced runs that
give the end-to-end metrics are not slowed by them.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

# host calls that launch work on the card, and host calls that wait for it
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cudaMemcpy",
              "cuMemcpyDtoH_v2", "cuMemcpy")
MARKER = "spin_kernel"     # torch.cuda._sleep: the clock-alignment launch


@dataclasses.dataclass
class Span:
    name: str
    request: int
    start: float      # host perf_counter seconds
    end: float


class Spans:
    """Spans of the benchmark's own calls; ``syncs`` counts the device
    synchronizes the spans themselves made."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.items: list[Span] = []
        self.syncs = 0

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
            self.syncs += 1

    @contextlib.contextmanager
    def span(self, name: str, request: int):
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.items.append(Span(name, request, start, time.perf_counter()))


@dataclasses.dataclass
class DeviceTrace:
    """The reduced trace: device operations (name, start ns, duration ns)
    in time order, the host's runtime calls counted by name, the window's
    bounds and the offset that takes a host perf_counter time (s) to the
    trace's clock (ns)."""
    ops: list
    calls: collections.Counter
    call_spans: list       # (start ns, end ns, name) of blocking calls
    window_ns: tuple
    host_to_trace_ns: float
    own_syncs: int = 2     # the profiler's own: after the marker, at stop

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted (start, end) ns."""
        lo, hi = self.window_ns
        out = []
        for _, start, dur in self.ops:
            s, e = max(start, lo), min(start + dur, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def count_calls(self, names) -> int:
        return sum(self.calls[n] for n in names)

    def kernel_times(self, fragment: str):
        """(count, total seconds) of the device operations whose name
        holds ``fragment``."""
        got = [dur for name, _, dur in self.ops if fragment in name]
        return len(got), sum(got) / 1e9

    def top_ops(self, n: int = 10):
        tot = collections.Counter()
        for name, _, dur in self.ops:
            tot[name[:120]] += dur / 1e9
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, spans: list[Span], n: int = 10):
        """Idle time between device operations inside the window, summed
        by what the host was doing: the blocking runtime call in progress
        at the gap's middle where there is one, else the innermost span,
        else 'host'."""
        busy = self.busy_intervals()
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        starts = [c[0] for c in self.call_spans]
        tot = collections.Counter()
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            label = "host"
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and self.call_spans[i][1] >= mid:
                label = self.call_spans[i][2]
            else:
                inner = [sp for sp in spans
                         if sp.start * 1e9 + self.host_to_trace_ns <= mid
                         <= sp.end * 1e9 + self.host_to_trace_ns]
                if inner:
                    label = "python in " + min(
                        inner, key=lambda sp: sp.end - sp.start).name
            tot[label] += (e - s) / 1e9
        return [[k, v] for k, v in tot.most_common(n)]


class Profiler:
    """A ``torch.profiler`` session over device activity (kernels, copies
    and the runtime calls CUPTI records with them), started and stopped by
    the harness around the traced requests."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_host = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_host = time.perf_counter()
        torch.cuda._sleep(1)          # the alignment marker
        torch.cuda.synchronize(self.device)

    def stop(self) -> DeviceTrace:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        ops, calls, blocking = [], collections.Counter(), []
        launches = []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if MARKER in name:
                    continue
                ops.append((name, e.start_ns(), e.duration_ns()))
                continue
            calls[name] += 1
            if name in LAUNCH_CALLS:
                launches.append(e.start_ns())
            if name in SYNC_CALLS or name.startswith("cudaMemcpy"):
                blocking.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                 name))
        ops.sort(key=lambda o: o[1])
        # the marker launch is the session's first launch: its host time
        # is t_host (to the microseconds that the call takes to begin)
        first = min(launches) if launches else (ops[0][1] if ops else 0)
        offset = first - self.t_host * 1e9
        if launches:
            calls.subtract({LAUNCH_CALLS[0]: 1})
        blocking.sort()
        window = (self.t_host * 1e9 + offset, t_end * 1e9 + offset)
        return DeviceTrace(ops, calls, blocking, window, offset)
