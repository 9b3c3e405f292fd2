"""The reader of ``loop.pg_graph_pct`` on counter sets as the program
records them: the share of the card's pose-graph solves that replayed a
graph, None where no solve ran on the card (a CPU run, or a version of the
port without the graph cache, which counts neither)."""
import _paths  # noqa: F401

import pytest

from harness import program_trace, runtime

READER = runtime.load_module(
    runtime.BENCH_DIR / "metrics" / "loop.pg_graph_pct.py",
    "bench_metric_loop_pg_graph_pct_test")


@pytest.mark.parametrize("counters,want", [
    ({}, None),
    ({"pose_graph.lm_iterations": 40, "pose_graph.lm_accepted": 14}, None),
    ({"ba.graph_replays": 48, "ba.eager_solves": 2}, None),
    ({"pose_graph.graph_replays": 2, "pose_graph.graph_captures": 1}, 100.0),
    ({"pose_graph.graph_replays": 3, "pose_graph.eager_solves": 1}, 75.0),
    ({"pose_graph.eager_solves": 2}, 0.0),
])
def test_pg_graph_pct_reads_the_replay_share(monkeypatch, counters, want):
    monkeypatch.setattr(program_trace, "counters", lambda: dict(counters))
    assert READER.read(None) == want
