"""The reader of ``sfm.ba_graph_pct`` on counter sets as the program
records them: the share of the card's BA solves that replayed a graph,
None where no solve ran on the card (a CPU run, or a version of the port
without the graph cache, which counts neither)."""
import _paths  # noqa: F401

import pytest

from harness import program_trace, runtime

READER = runtime.load_module(
    runtime.BENCH_DIR / "metrics" / "sfm.ba_graph_pct.py",
    "bench_metric_sfm_ba_graph_pct_test")


@pytest.mark.parametrize("counters,want", [
    ({}, None),
    ({"ba.lm_iterations": 520, "ba.lm_accepted": 389}, None),
    ({"ba.graph_replays": 48}, 100.0),
    ({"ba.graph_replays": 3, "ba.eager_solves": 1}, 75.0),
    ({"ba.eager_solves": 2}, 0.0),
])
def test_ba_graph_pct_reads_the_replay_share(monkeypatch, counters, want):
    monkeypatch.setattr(program_trace, "counters", lambda: dict(counters))
    assert READER.read(None) == want
