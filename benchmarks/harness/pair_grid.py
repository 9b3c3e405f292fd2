"""Loop closure's pair grid on the card: its bytes, and the device time of
its Hamming launches.  The grid is the batched entry of the Hamming kernel
over every frame pair of a sequence (``sfm/loop_closure.py``
``pairwise_match_counts``): (F, K, P) uint8 bits and (F, K) masks in, Q
(K, K) int32 distance matrices out."""
from __future__ import annotations

from harness import program_trace

KERNEL = "hamming_mma_kernel"


def grid_bytes(f: int, k: int, p: int, q: int) -> int:
    """F K (P + 1) bytes of bits and masks read once, Q K K int32 written
    once: 557.7 MB at F = 23, K = 512, P = 256, Q = 529."""
    return f * k * (p + 1) + 4 * q * k * k


def kernel_time_in(run, span: str, fragment: str = KERNEL):
    """(launches, seconds) of the device operations named ``fragment``
    whose start falls inside one of the program's spans ``span``, the
    spans laid on the trace's clock by ``host_to_trace_ns``; (0, 0.0)
    without a trace or such spans."""
    if run.trace is None:
        return 0, 0.0
    off = run.trace.host_to_trace_ns
    got = [(s.start * 1e9 + off, s.end * 1e9 + off)
           for s in program_trace.spans((span,))]
    durs = [dur for name, start, dur in run.trace.ops
            if fragment in name and any(a <= start <= b for a, b in got)]
    return len(durs), sum(durs) / 1e9
